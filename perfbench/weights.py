"""Weights and inputs made from ``--seed``, on the device, in a few large
calls: the same seed gives the same numbers on both sides of a comparison.

Parameter names are those of the program's predictor (the dict loads into it
with ``load_state_dict``); the reference reads the same dict. Fp32 storage,
as the program keeps its parameters (a bf16 configuration computes in bf16).

Images: ``prototypes`` noise images whose patch tokens, through the frozen
ViT to its encode layer (the reference's fp32 forward, on the benchmark's
side), give the codebook; every image of a pool is one of the first
``floor(M / L)`` prototypes plus Gaussian noise of ``noise`` std. So each
token lies near its prototype token's code, as tokens lie near their
k-means centres under a trained codebook, and a rounding of the features
does not reassign codes the way it would among equidistant noise tokens.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from perfbench.reference import model as ref
from perfbench.reference.precision import Precision

SEED_MIX = 1_000_003
EMBED_SHARED = 0.5


def generator(seed: int, tag: int, device) -> torch.Generator:
    """A generator on ``device`` for one use (``tag``) of a run's seed."""
    return torch.Generator(device=device).manual_seed((int(seed) * SEED_MIX + tag) % 2**63)


def shapes(cfg: dict) -> Dict[str, tuple]:
    """name -> (shape, init) of every parameter and buffer of the predictor."""
    t, pe = cfg["model"]["transformer"], cfg["model"]["patch_embed"]
    d, f, layers = t["embed_dim"], t["dim_feedforward"], t["num_encoder_layers"]
    ps, img, ch = pe["patch_size"], pe["img_size"], pe["image_channels"]
    k, m = cfg["num_classes"], cfg["num_codes"]
    a = cfg["schema_net"]["ir_atlas"]
    v = a.get("class_max_vertices") or m
    g = cfg["schema_net"]["gnn"]
    dg = g["embed_dim"]
    n = (img // ps) ** 2 + 1
    out = {ref.VIT + "patch_embed.proj.weight": ((d, ch, ps, ps), "normal"),
           ref.VIT + "patch_embed.proj.bias": ((d,), "zeros"),
           ref.VIT + "pos_embed.pos_embed": ((1, n, d), "normal"),
           ref.VIT + "cls_token": ((1, 1, d), "normal")}
    for i in range(layers):
        p = f"{ref.VIT}transformer.layers.{i}."
        for name, shape in (("attention.linear_qkv", (3 * d, d)), ("attention.linear_out", (d, d)),
                            ("mlp.linear1", (f, d)), ("mlp.linear2", (d, f))):
            out[p + name + ".weight"] = (shape, "normal")
            out[p + name + ".bias"] = ((shape[0],), "zeros")
        for name in ("norm1", "norm2"):
            out[p + name + ".weight"] = ((d,), "ones")
            out[p + name + ".bias"] = ((d,), "zeros")
    out[ref.VIT + "transformer.norm.weight"] = ((d,), "ones")
    out[ref.VIT + "transformer.norm.bias"] = ((d,), "zeros")
    out[ref.VIT + "cls_head.weight"] = ((k, d), "normal")
    out[ref.VIT + "cls_head.bias"] = ((k,), "zeros")
    out[ref.CODEBOOK] = ((m, d), "codebook")
    out[ref.ATLAS + "vertex_weights"] = ((k, v), "rows")
    out[ref.ATLAS + "edge_weights"] = ((k, v, v), "rows")
    out[ref.ATLAS + "vertex_attribute_weights"] = ((2, 1), "half")
    out[ref.ATLAS + "edge_attribute_weights"] = ((2, 1), "half")
    out[ref.ATLAS + "class_ingredients"] = ((k, v), "ingredients")
    out[ref.GNN + "embedding"] = ((m + 1, dg), "embedding")
    for i in range(g["num_layers"]):
        p = f"{ref.GNN}layers.{i}."
        out[p + "g_conv.linear.weight"] = ((dg, dg), "xavier")
        out[p + "g_conv.linear.bias"] = ((dg,), "zeros")
        out[p + "norm.weight"] = ((dg,), "ones")
        out[p + "norm.bias"] = ((dg,), "zeros")
    out[ref.GNN + "fc.weight"] = ((dg, dg), "xavier")
    out[ref.GNN + "fc.bias"] = ((dg,), "zeros")
    return out


def _split(flat: torch.Tensor, items: List[tuple]) -> Dict[str, torch.Tensor]:
    out, at = {}, 0
    for name, shape in items:
        size = math.prod(shape)
        out[name] = flat[at:at + size].view(shape)
        at += size
    return out


def make_state(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter and buffer from ``seed``: ViT weights N(0, 0.02)
    (DeiT's), biases 0, norms 1; atlas rows 0.5 + N(0, 1/6) clipped to
    [0, 1] and normalised; attribute weights 0.5; class ingredients ``V``
    distinct codes a class (``ingredients``); GNN embedding N(0, 1)
    clipped to 2 std (the padding row 0), Linear weights xavier-uniform.
    The codebook is left out (``make_codebook``)."""
    spec = shapes(cfg)
    by_kind: Dict[str, List[tuple]] = {}
    for name, (shape, kind) in spec.items():
        by_kind.setdefault(kind, []).append((name, shape))
    size = lambda kind: sum(math.prod(s) for _, s in by_kind.get(kind, []))  # noqa: E731
    out: Dict[str, torch.Tensor] = {}
    g = generator(seed, 1, device)
    out.update(_split(torch.randn(size("normal"), generator=g, device=device) * 0.02,
                      by_kind["normal"]))
    for kind, value in (("zeros", 0.0), ("ones", 1.0), ("half", 0.5)):
        for name, shape in by_kind.get(kind, []):
            out[name] = torch.full(shape, value, device=device)
    for name, shape in by_kind["rows"]:
        x = (0.5 + torch.randn(shape, generator=g, device=device) / 6).clamp_(0.0, 1.0)
        out[name] = x / x.sum(dim=-1, keepdim=True).clamp(min=1e-12)
    for name, shape in by_kind["xavier"]:
        limit = math.sqrt(6.0 / (shape[0] + shape[1]))
        out[name] = (torch.rand(shape, generator=g, device=device) * 2 - 1) * limit
    (name, shape), = by_kind["embedding"]
    out[name] = embedding(cfg, shape, g, device)
    (name, (k, v)), = by_kind["ingredients"]
    out[name] = ingredients(cfg, k, v, g, device)
    return out


def _prototype_of_codes(cfg: dict, device) -> torch.Tensor:
    """[M]: the prototype whose token each code is (code ``i`` is token
    ``i % L`` of prototype ``i // L``, ``make_codebook``)."""
    pe = cfg["model"]["patch_embed"]
    tokens = (pe["img_size"] // pe["patch_size"]) ** 2
    return torch.arange(cfg["num_codes"], device=device) // tokens


def embedding(cfg: dict, shape, g: torch.Generator, device) -> torch.Tensor:
    """[M + 1, D] GNN embedding: each code's row N(0, 1), ``EMBED_SHARED``
    of its variance a direction its prototype's codes share, clipped to 2
    std; the padding row 0."""
    proto = _prototype_of_codes(cfg, device)
    shared = torch.randn(int(proto[-1]) + 1, shape[1], generator=g, device=device)
    emb = torch.randn(shape, generator=g, device=device) * math.sqrt(1.0 - EMBED_SHARED)
    emb[:-1] += shared[proto] * math.sqrt(EMBED_SHARED)
    emb.clamp_(-2.0, 2.0)
    emb[-1] = 0.0
    return emb


def ingredients(cfg: dict, k: int, v: int, g: torch.Generator, device) -> torch.Tensor:
    """[K, V] distinct codes a class, ascending: the codes of prototypes
    taken in an order drawn for the class, all of the first ones and a drawn
    share of the last. So a class's graph holds the codes of the images
    near its prototypes, as a trained atlas holds the codes its class's
    images show, and the classes' logits differ by more than rounding: a
    served answer mapped to the wrong classes moves them by their spread."""
    m = cfg["num_codes"]
    proto = _prototype_of_codes(cfg, device)
    rank = torch.rand(k, int(proto[-1]) + 1, generator=g, device=device).argsort(dim=1)
    rank = rank.argsort(dim=1).float()  # each prototype's place in the class's order
    key = rank[:, proto] + torch.rand(k, m, generator=g, device=device)
    return key.argsort(dim=1)[:, :v].sort(dim=1).values.int()


def prototypes(cfg: dict, seed: int, device) -> torch.Tensor:
    """[P, H, W, C] noise images, P = ceil(M / L)."""
    pe = cfg["model"]["patch_embed"]
    img, ch = pe["img_size"], pe["image_channels"]
    n = math.ceil(cfg["num_codes"] / (img // pe["patch_size"]) ** 2)
    return torch.randn(n, img, img, ch, generator=generator(seed, 2, device), device=device)


@torch.no_grad()
def make_codebook(cfg: dict, seed: int, device, vit_state: Dict[str, torch.Tensor]) -> torch.Tensor:
    """[M, d]: the first M patch tokens of the prototypes at the encode
    layer, by the reference's fp32 forward (TF32 off)."""
    p = Precision("fp32")
    with p.scope():
        feats, _ = ref.vit_encode(vit_state, cfg, prototypes(cfg, seed, device), p)
    return feats.reshape(-1, feats.shape[-1])[:cfg["num_codes"]].contiguous()


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The whole state: the ViT first, then the codebook from it, then the rest."""
    state = make_state(cfg, seed, device)
    state[ref.CODEBOOK] = make_codebook(cfg, seed, device, state)
    missing = set(shapes(cfg)) ^ set(state)
    if missing:
        raise KeyError(f"weights made and weights named differ: {sorted(missing)}")
    return state


def make_pool(cfg: dict, seed: int, device, count: int, noise: float):
    """(images [count, H, W, C], labels [count]) of a traffic pool: images
    near the usable prototypes, labels uniform over K."""
    protos = prototypes(cfg, seed, device)
    usable = cfg["num_codes"] // (protos.shape[1] // cfg["model"]["patch_embed"]["patch_size"]) ** 2
    g = generator(seed, 3, device)
    which = torch.randint(0, max(usable, 1), (count,), generator=g, device=device)
    images = protos[which] + noise * torch.randn((count, *protos.shape[1:]), generator=g,
                                                 device=device)
    labels = torch.randint(0, cfg["num_classes"], (count,), generator=g, device=device)
    return images, labels
