"""The plain reference of the benchmark's cells: SchemaNet written out in
plain PyTorch from its equations, fp32, with no kernel, cache or batching
trick of the program under test, and importing nothing of it.

``model.py`` holds the forward pieces (frozen ViT to the encode layer, VQ,
instance graphs, atlas getters, GNN, matcher, loss), the stage-4 step
(autograd, AdamW with the atlas projection) and stage 3's two passes;
``precision.py`` the rounding of every product's operands (fp32 with TF32
off, TF32, or fp8 e4m3), which the lower-precision controls use.
"""
