"""The port's GNN embedding gradient in bf16, on the CPU.

The JAX package sums the cotangent rows of duplicate ids in fp32 and rounds
once to the compute dtype (``schemanet_tpu/schema/gnn.py``
``_embed_lookup_bwd``). Summed in bf16 instead, the running sum stops growing
once the addends fall below half its ulp.
"""

import torch

from schemanet_torch.schema.gnn import GNN


def test_bf16_embedding_gradient_sums_duplicate_ids_in_fp32():
    """4,096 vertices all holding code 0, mean-pooled through an identity fc:
    every cotangent row is exactly 2^-12 in bf16 and they sum to exactly 1.
    A bf16 running sum stalls near 2^-4, where 2^-12 is below half an ulp."""
    n = 4096
    gnn = GNN(num_codes=3, embed_dim=2, num_layers=0, dtype=torch.bfloat16)
    with torch.no_grad():
        gnn.embedding.copy_(torch.randn(4, 2, generator=torch.Generator().manual_seed(0)))
        gnn.fc.weight.copy_(torch.eye(2))
        gnn.fc.bias.zero_()
    nodes = torch.ones(1, n, dtype=torch.bfloat16)
    ids = torch.zeros(1, n, dtype=torch.int32)
    out = gnn(nodes, torch.zeros(1, 1, 1, dtype=torch.bfloat16), ids)
    out.float().sum().backward()
    torch.testing.assert_close(gnn.embedding.grad, torch.tensor(
        [[1.0, 1.0], [0.0, 0.0], [0.0, 0.0], [0.0, 0.0]]), rtol=0, atol=0)
