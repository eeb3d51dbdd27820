from .vit import DeiT, ViT, get_model
