"""SchemaNet in plain PyTorch, fp32, from its equations.

Weights arrive as one dict keyed by the parameter names the benchmark uses
for both sides (``weights.py``): the frozen ViT under ``VIT``, the codebook
``CODEBOOK``, the atlas under ``ATLAS``, the GNN under ``GNN``. A config is
the benchmark's configuration file, parsed.

The pieces, each from the paper's definitions (Zhang et al., "Schema
Inference for Interpretable Image Classification", ICLR 2023) and the
project's YAML semantics:

* frozen ViT: patch convolution, cls token, learned positions, pre-norm
  layers ``x + attn(LN1 x)``, ``y + ffn(LN2 y)`` (exact-erf gelu), run to the
  encode layer inclusive; its head-mean of the scaled pre-softmax scores;
* VQ: the nearest code by ``||c||^2 - 2 x.c``, ties to the lower id;
* an instance graph per image: its distinct codes ascending as vertices,
  (count, mean CLS attention) max-normalised and blended by the vertex
  attribute weights; edges the per-pair means of (geometry, attention),
  row-normalised and blended by the edge attribute weights;
* the atlas: vertex weights clamped at 1e-5 and row-normalised, edge
  weights with pruned vertices' edges zeroed, clamped at 0 and row-normalised
  (row sums held constant for the gradient);
* the GNN: embedding lookup, layers of ``((E + E^T)/2 + I) F``, Linear, the
  padding zeroed, LayerNorm (eps 1e-6), relu; weighted sum pooling over the
  pool size; a final Linear; logits by the inner product;
* the loss: cross entropy plus the rectified entropies of the class vertices
  (max over classes) and the class edges (mean over classes of the max over
  rows);
* AdamW (b 0.9/0.999, eps 1e-8, decoupled decay) by the config's groups,
  the vertex and edge weights projected back onto rows that sum to one after
  each update, the attribute weights clamped to [0.01, 10] before each step;
* stage 3: per class, the mean of its images' full-vocabulary vertex
  weights, its top ``V_max`` codes, and the mean of its images' edges over
  those codes.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from .precision import Precision

VIT = "ingredient_backbone.backbone."
CODEBOOK = "ingredient_backbone.vocabulary"
ATLAS = "schema_net."
GNN = "matcher.gnn."
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
GNN_EPS, ENTROPY_EPS = 1e-6, 1e-7


def _zero_nan(x: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0) if x.isnan().any() else x


# -- frozen ViT ---------------------------------------------------------------

def vit_encode(W: Dict[str, torch.Tensor], cfg: dict, img: torch.Tensor, P: Precision,
               block: int = 32):
    """(patch features [B, L, d] after the encode layer, head-mean of its
    scaled raw scores [B, n, n]) of NHWC images, ``block`` images at a time."""
    feats, hmeans = [], []
    for s in range(0, img.shape[0], block):
        f, h = _vit_block(W, cfg, img[s:s + block].float(), P)
        feats.append(f)
        hmeans.append(h)
    return torch.cat(feats), torch.cat(hmeans)


def _vit_block(W, cfg, img, P):
    t, pe = cfg["model"]["transformer"], cfg["model"]["patch_embed"]
    d, heads, eps = t["embed_dim"], t["num_heads"], t["norm_eps"]
    dh = d // heads
    x = img.permute(0, 3, 1, 2)
    y = P.r(F.conv2d(P.r(x), P.r(W[VIT + "patch_embed.proj.weight"].float()),
                     W[VIT + "patch_embed.proj.bias"].float(), stride=pe["patch_size"]))
    seq = y.flatten(2).transpose(1, 2)
    b = seq.shape[0]
    seq = torch.cat([W[VIT + "cls_token"].float().expand(b, 1, d), seq], dim=1)
    seq = seq + W[VIT + "pos_embed.pos_embed"].float()
    n = seq.shape[1]
    hmean = None
    for i in range(cfg["encode_layer"] + 1):
        p = f"{VIT}transformer.layers.{i}."
        w = lambda k: W[p + k].float()  # noqa: E731
        h = F.layer_norm(seq, (d,), w("norm1.weight"), w("norm1.bias"), eps)
        qkv = P.lin(h, w("attention.linear_qkv.weight"), w("attention.linear_qkv.bias"))
        q, k, v = qkv.reshape(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
        raw = P.mm(q / math.sqrt(dh), k.transpose(-1, -2))
        o = P.mm(torch.softmax(raw, dim=-1), v).transpose(1, 2).reshape(b, n, d)
        seq = seq + P.lin(o, w("attention.linear_out.weight"), w("attention.linear_out.bias"))
        h = F.layer_norm(seq, (d,), w("norm2.weight"), w("norm2.bias"), eps)
        h = F.gelu(P.lin(h, w("mlp.linear1.weight"), w("mlp.linear1.bias")))
        seq = seq + P.lin(h, w("mlp.linear2.weight"), w("mlp.linear2.bias"))
        if i == cfg["encode_layer"]:
            hmean = raw.mean(dim=1)
    return seq[:, 1:], hmean


def vq(x: torch.Tensor, codebook: torch.Tensor, P: Precision, rows: int = 4096) -> torch.Tensor:
    """Nearest-code ids [...] of x [..., d]; ties to the lower id."""
    flat = x.reshape(-1, x.shape[-1]).float()
    c = codebook.float()
    norms = (c * c).sum(-1)
    out = []
    for s in range(0, flat.shape[0], rows):
        score = norms[None, :] - 2 * P.lin(flat[s:s + rows], c)
        out.append(score.argmin(dim=-1))  # first minimum: the lower id on a tie
    return torch.cat(out).reshape(x.shape[:-1])


# -- graphs -------------------------------------------------------------------

def geometry(cfg: dict, device) -> torch.Tensor:
    a = cfg["schema_net"]["ir_atlas"]
    h, w, pw = a["feat_h"], a["feat_w"], float(a.get("dist_pow", 2.0))
    alpha = float(a.get("dist_alpha", 1.0))
    ii, jj = torch.meshgrid(torch.arange(h, dtype=torch.float64),
                            torch.arange(w, dtype=torch.float64), indexing="ij")
    pts = torch.stack([ii.reshape(-1), jj.reshape(-1)], dim=1)
    dist = ((pts[:, None, :] - pts[None, :, :]).abs() ** pw).sum(-1) ** (1.0 / pw)
    return (1.0 / (1.0 + dist / alpha)).float().to(device)


def clamp_softmax(x: torch.Tensor, clamp: Optional[float]) -> torch.Tensor:
    """Scores below ``clamp`` masked, then the softmax; an all-masked row is
    NaN (the callers map it to 0)."""
    if clamp is not None:
        x = x.masked_fill(x < clamp, float("-inf"))
    m = x.amax(dim=-1, keepdim=True)
    e = torch.exp(x - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    return e / e.sum(dim=-1, keepdim=True)


def instance_graphs(ids: torch.Tensor, hmean: torch.Tensor, W: dict, cfg: dict, geo):
    """Per image: its distinct codes ascending in slots 0..S-1, padding code
    M after; vertex weights [B, L], edges [B, L, L], live mask [B, L]."""
    a = cfg["schema_net"]["ir_atlas"]
    m = cfg["num_codes"]
    wv, we = W[ATLAS + "vertex_attribute_weights"][:, 0], W[ATLAS + "edge_attribute_weights"][:, 0]
    b, L = ids.shape
    attn = _zero_nan(clamp_softmax(hmean[:, 1:, 1:].float(), a.get("clamp_edge_attn")))
    attn_cls = _zero_nan(clamp_softmax(hmean[:, 0, 1:].float(), a.get("clamp_vertex_attn")))
    codes = torch.full((b, L), m, dtype=torch.long, device=ids.device)
    proj = torch.zeros(b, L, L, device=ids.device)
    for i in range(b):
        uniq, inv = torch.unique(ids[i], sorted=True, return_inverse=True)
        codes[i, :len(uniq)] = uniq
        proj[i, torch.arange(L, device=ids.device), inv] = 1.0
    count = proj.sum(dim=1)  # [B, S]
    live = count > 0
    attn_val = torch.einsum("bls,bl->bs", proj, attn_cls) / count.clamp(min=1.0)
    attrs = torch.stack([count, attn_val], dim=-1)
    attrs = _zero_nan(attrs / attrs.amax(dim=1, keepdim=True))
    vertices = torch.where(live, attrs @ wv, torch.zeros_like(count))
    pairs = count[:, :, None] * count[:, None, :]
    pt = proj.transpose(1, 2)
    means = []
    for mat in (geo[None].expand(b, L, L), attn):
        e = (pt @ mat @ proj) / pairs.clamp(min=1.0)
        e = torch.where(pairs > 0, e, torch.zeros_like(e))
        means.append(_zero_nan(e / e.sum(dim=2, keepdim=True)))
    if a.get("remove_self_loop"):
        eye = torch.eye(L, dtype=torch.bool, device=ids.device)
        means = [e.masked_fill(eye, 0.0) for e in means]
    edges = means[0] * we[0] + means[1] * we[1]
    edges = torch.where(live[:, :, None] & live[:, None, :], edges, torch.zeros_like(edges))
    return {"codes": codes, "vertices": vertices, "edges": edges, "live": live,
            "num_slots": live.sum(dim=1)}


def _norm_rows_clamped(x: torch.Tensor, floor: float) -> torch.Tensor:
    """max(x, floor) over its row's sum, the sum held constant for the
    gradient; an all-zero row stays 0."""
    x = torch.maximum(x, torch.tensor(floor, device=x.device))
    s = x.sum(dim=-1, keepdim=True).detach()
    return torch.where(s == 0, torch.zeros_like(x), x / torch.where(s == 0, torch.ones_like(s), s))


def class_graphs(W: dict, cfg: dict):
    """(class vertices [K, V], class edges [K, V, V]) from the atlas."""
    a = cfg["schema_net"]["ir_atlas"]
    cv = _norm_rows_clamped(W[ATLAS + "vertex_weights"], 1e-5)
    e = W[ATLAS + "edge_weights"]
    thr = a.get("prune_node_threshold")
    if thr is not None:
        keep = (cv.detach() > thr).float()
        e = e * (keep[:, :, None] * keep[:, None, :])
    ce = _norm_rows_clamped(e, 0.0)
    if a.get("remove_self_loop"):
        ce = ce.masked_fill(torch.eye(ce.shape[-1], dtype=torch.bool, device=ce.device), 0.0)
    return cv, ce


# -- GNN, matcher, loss -------------------------------------------------------

def gnn_embed(W: dict, cfg: dict, nodes, edges, codes, live, denom, P: Precision):
    """Pooled graph features [N, D]: ``live`` None for graphs with no padding."""
    g = cfg["schema_net"]["gnn"]
    d = g["embed_dim"]
    feat = W[GNN + "embedding"][codes]
    eye = torch.eye(edges.shape[-1], device=edges.device)
    e_sym = 0.5 * (edges + edges.transpose(-1, -2)) + eye
    for i in range(g["num_layers"]):
        p = f"{GNN}layers.{i}."
        feat = P.mm(e_sym, feat)
        feat = P.lin(feat, W[p + "g_conv.linear.weight"], W[p + "g_conv.linear.bias"])
        if live is not None:
            feat = torch.where(live[..., None], feat, torch.zeros_like(feat))
        feat = F.relu(F.layer_norm(feat, (d,), W[p + "norm.weight"], W[p + "norm.bias"], GNN_EPS))
    pooled = (feat * nodes[..., None]).sum(dim=1) / denom
    return P.lin(pooled, W[GNN + "fc.weight"], W[GNN + "fc.bias"])


def class_features(W: dict, cfg: dict, P: Precision, block: Optional[int] = None):
    """([K, D] class features, class vertices, class edges); ``block``
    classes at a time (no autograd then)."""
    cv, ce = class_graphs(W, cfg)
    ci = W[ATLAS + "class_ingredients"].long()
    v = cv.shape[1]
    if block is None:
        return gnn_embed(W, cfg, cv, ce, ci, None, float(v), P), cv, ce
    out = [gnn_embed(W, cfg, cv[s:s + block], ce[s:s + block], ci[s:s + block], None, float(v), P)
           for s in range(0, cv.shape[0], block)]
    return torch.cat(out), cv, ce


def instance_features(W, cfg, img, P, per_sample: bool):
    feats, hmean = vit_encode(W, cfg, img, P)
    ids = vq(feats, W[CODEBOOK], P)
    inst = instance_graphs(ids, hmean, W, cfg, geometry(cfg, img.device))
    slots = inst["num_slots"].clamp(min=1).float()
    denom = slots[:, None] if per_sample else slots.max()
    return gnn_embed(W, cfg, inst["vertices"], inst["edges"], inst["codes"], inst["live"],
                     denom, P)


def _entropy(p: torch.Tensor) -> torch.Tensor:
    return -(p * torch.log(p + ENTROPY_EPS)).sum(dim=-1)


def _rectify(x: torch.Tensor, a: float) -> torch.Tensor:
    return torch.where(x > a, x, a - 1.0 + 1.0 / (1.0 + a - x))


def schema_loss(logits, labels, cv, ce, cfg) -> torch.Tensor:
    w = cfg["loss"]["weight_dict"]
    lc = cfg["loss"].get("loss_cfg") or {}
    ev = _entropy(cv).amax()
    ee = _entropy(ce).amax(dim=1).mean()
    return (w["cls"] * F.cross_entropy(logits, labels.long())
            + w["re_entropy_vertex"] * _rectify(ev, lc.get("re_a_vertex", 3.0))
            + w["re_entropy_edge"] * _rectify(ee, lc.get("re_a_edge", 3.0)))


# -- serving ------------------------------------------------------------------

@torch.no_grad()
def serve_logits(W: dict, cfg: dict, images: torch.Tensor, P: Precision,
                 block: int = 64, class_block: int = 100) -> torch.Tensor:
    """Logits [n, K] of images, each pooled by its own live-slot count."""
    with P.scope(), P.compute():
        kg, _, _ = class_features(W, cfg, P, class_block)
        out = [P.mm(instance_features(W, cfg, images[s:s + block], P, True), kg.t())
               for s in range(0, images.shape[0], block)]
    return torch.cat(out)


# -- stage 4 ------------------------------------------------------------------

def trainable_groups(cfg: dict, names: Sequence[str]) -> Dict[str, dict]:
    """Each trainable leaf's AdamW settings by the config's groups (the
    first group whose pattern starts its name; the rest frozen under
    ``drop_remain``)."""
    tr = cfg["training"]
    base_wd = float(tr["optimizer"].get("weight_decay", 0.0))
    base_lr = float(tr["optimizer"]["lr"])
    out = {}
    for name in names:
        for group in tr.get("param_groups") or []:
            if name.startswith(group["pattern"]):
                gc = group.get("cfg") or {}
                out[name] = {"lr": float(gc.get("lr", base_lr)),
                             "weight_decay": float(gc.get("weight_decay", base_wd))}
                break
    return out


def projected_rows(cfg: dict) -> List[str]:
    """The atlas leaves an update is projected back onto rows that sum to
    one (``apply_normalize``)."""
    a = cfg["schema_net"]["ir_atlas"]
    return ([ATLAS + "vertex_weights", ATLAS + "edge_weights"]
            if a.get("apply_normalize", True) else [])


def _project_(W: dict, cfg: dict) -> None:
    a = cfg["schema_net"]["ir_atlas"]
    if a.get("clamp_weights", True):
        for k in ("vertex_attribute_weights", "edge_attribute_weights"):
            W[ATLAS + k].clamp_(0.01, 10.0)
    if a.get("apply_normalize", True):
        for k in ("vertex_weights", "edge_weights"):
            _project_rows_(W[ATLAS + k], bool(a.get("remove_self_loop")) and k == "edge_weights")


def _project_rows_(w: torch.Tensor, remove_self_loop: bool) -> None:
    w.clamp_(min=0.0)
    s = w.sum(dim=-1, keepdim=True)
    w.copy_(torch.where(s > 0, w / torch.where(s > 0, s, torch.ones_like(s)), torch.zeros_like(w)))
    if remove_self_loop:
        w.diagonal(dim1=-2, dim2=-1).zero_()


def train_steps(W: dict, cfg: dict, batches: List[dict], P: Precision,
                trainable: Sequence[str]) -> dict:
    """Stage-4 steps from weights ``W`` (a dict it changes: pass copies), one
    a batch: ``{"loss": [...], "grad_norm": {leaf: ||g|| of step 1},
    "change_norm": {leaf: ||p_after - p_before||}}``. ``trainable``: the
    leaves the config trains (the atlas and the GNN)."""
    groups = trainable_groups(cfg, trainable)
    a = cfg["schema_net"]["ir_atlas"]
    hot = projected_rows(cfg)
    with P.scope():
        with torch.no_grad():
            _project_(W, cfg)
        start = {k: W[k].detach().clone() for k in groups}
        moments = {k: (torch.zeros_like(W[k]), torch.zeros_like(W[k])) for k in groups}
        losses, grad_norm = [], {}
        for step, batch in enumerate(batches):
            with torch.no_grad():
                if a.get("clamp_weights", True):
                    for k in ("vertex_attribute_weights", "edge_attribute_weights"):
                        W[ATLAS + k].clamp_(0.01, 10.0)
            leaves = {k: W[k].detach().requires_grad_(True) for k in groups}
            Wg = {**W, **leaves}
            with P.compute():
                loss = _step_loss(Wg, cfg, batch, P)
                grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
            losses.append(float(loss.detach()))
            t = step + 1
            with torch.no_grad():
                for (k, p), g in zip(leaves.items(), grads):
                    g = torch.zeros_like(p) if g is None else g
                    if step == 0:
                        grad_norm[k] = float(g.double().norm())
                    m, v = moments[k]
                    m.mul_(ADAM_B1).add_((1 - ADAM_B1) * g)
                    v.mul_(ADAM_B2).add_((1 - ADAM_B2) * g * g)
                    u = (m / (1 - ADAM_B1 ** t)) / ((v / (1 - ADAM_B2 ** t)).sqrt() + ADAM_EPS)
                    hp = groups[k]
                    new = p.detach() - hp["lr"] * (u + hp["weight_decay"] * p.detach())
                    if k in hot:
                        _project_rows_(new, bool(a.get("remove_self_loop"))
                                       and k.endswith("edge_weights"))
                    W[k] = new
            del leaves, Wg, grads, loss
        change = {k: float((W[k].double() - start[k].double()).norm()) for k in groups}
    return {"loss": losses, "grad_norm": grad_norm, "change_norm": change}


def _step_loss(W, cfg, batch, P):
    with torch.no_grad():  # the frozen backbone
        feats, hmean = vit_encode(W, cfg, batch["image"], P)
        ids = vq(feats, W[CODEBOOK], P)
    # the attribute weights reach the instance graphs: built with autograd
    inst = instance_graphs(ids, hmean, W, cfg, geometry(cfg, feats.device))
    slots = inst["num_slots"].clamp(min=1).float().max()
    fi = gnn_embed(W, cfg, inst["vertices"], inst["edges"], inst["codes"], inst["live"], slots, P)
    kg, cv, ce = class_features(W, cfg, P)
    return schema_loss(P.mm(fi, kg.t()), batch["label"], cv, ce, cfg)


# -- stage 3 ------------------------------------------------------------------

@torch.no_grad()
def full_vertices(ids: torch.Tensor, hmean: torch.Tensor, W: dict, cfg: dict) -> torch.Tensor:
    """[B, M] vertex weights over the whole vocabulary."""
    a = cfg["schema_net"]["ir_atlas"]
    m = cfg["num_codes"]
    wv = W[ATLAS + "vertex_attribute_weights"][:, 0]
    attn_cls = clamp_softmax(hmean[:, 0, 1:].float(), a.get("clamp_vertex_attn"))
    b = ids.shape[0]
    count = torch.zeros(b, m, device=ids.device).scatter_add_(1, ids, torch.ones_like(attn_cls))
    asum = torch.zeros(b, m, device=ids.device).scatter_add_(1, ids, attn_cls)
    aval = torch.where(count > 0, asum / count.clamp(min=1.0), torch.zeros_like(asum))
    attrs = torch.stack([count, aval], dim=-1)
    attrs = _zero_nan(attrs / attrs.amax(dim=1, keepdim=True))
    return attrs @ wv


@torch.no_grad()
def limited_edges(ids, hmean, codes_of_label, W, cfg, geo) -> torch.Tensor:
    """[B, V, V] edges of each image over its class's ingredient codes."""
    a = cfg["schema_net"]["ir_atlas"]
    we = W[ATLAS + "edge_attribute_weights"][:, 0]
    attn = clamp_softmax(hmean[:, 1:, 1:].float(), a.get("clamp_edge_attn"))
    proj = (ids[:, :, None] == codes_of_label[:, None, :]).float()  # [B, L, V]
    count = proj.sum(dim=1)
    pairs = count[:, :, None] * count[:, None, :]
    pt = proj.transpose(1, 2)
    means = []
    for mat in (geo[None].expand(ids.shape[0], -1, -1), attn):
        e = (pt @ mat @ proj) / pairs.clamp(min=1.0)
        e = torch.where(pairs > 0, e, torch.zeros_like(e))
        means.append(_zero_nan(e / e.sum(dim=2, keepdim=True)))
    if a.get("remove_self_loop"):
        eye = torch.eye(means[0].shape[-1], dtype=torch.bool, device=ids.device)
        means = [e.masked_fill(eye, 0.0) for e in means]
    return means[0] * we[0] + means[1] * we[1]


@torch.no_grad()
def init_classes(W: dict, cfg: dict, passes: List[List[dict]], classes: torch.Tensor,
                 P: Precision, block: int = 32) -> dict:
    """Stage 3's atlas rows of ``classes`` from the images of those classes
    in ``passes`` (the batches of pass 1 and of pass 2): ``vertex_weights``
    [C, V], ``class_ingredients`` [C, V], ``edge_weights`` [C, V, V],
    projected (rows clamped at 0 and summing to one)."""
    a = cfg["schema_net"]["ir_atlas"]
    m = cfg["num_codes"]
    v_max = a.get("class_max_vertices") or m
    dev = classes.device
    c = len(classes)
    slot_of = torch.full((cfg["num_classes"],), -1, dtype=torch.long, device=dev)
    slot_of[classes] = torch.arange(c, device=dev)
    geo = geometry(cfg, dev)
    with P.scope(), P.compute():
        acc, counts = torch.zeros(c, m, device=dev), torch.zeros(c, device=dev)
        for img, lab in _class_images(passes[0], slot_of, block):
            feats, hmean = vit_encode(W, cfg, img, P)
            ids = vq(feats, W[CODEBOOK], P)
            s = slot_of[lab]
            acc.index_add_(0, s, full_vertices(ids, hmean, W, cfg))
            counts.index_add_(0, s, torch.ones_like(s, dtype=torch.float))
        cv = acc / counts.clamp(min=1.0)[:, None]
        cv = cv / cv.sum(dim=-1, keepdim=True).clamp(min=1e-12)
        weights, order = torch.sort(cv, dim=-1, descending=True, stable=True)
        weights, ingredients = weights[:, :v_max].contiguous(), order[:, :v_max]
        acc_e = torch.zeros(c, v_max, v_max, device=dev)
        for img, lab in _class_images(passes[1], slot_of, block):
            feats, hmean = vit_encode(W, cfg, img, P)
            ids = vq(feats, W[CODEBOOK], P)
            s = slot_of[lab]
            acc_e.index_add_(0, s, limited_edges(ids, hmean, ingredients[s], W, cfg, geo))
        edges = acc_e / counts.clamp(min=1.0)[:, None, None]
    _project_rows_(weights, False)
    _project_rows_(edges, bool(a.get("remove_self_loop")))
    return {"vertex_weights": weights, "class_ingredients": ingredients, "edge_weights": edges,
            "images": counts}


def _class_images(batches, slot_of, block):
    """The images of the kept classes, ``block`` at a time, with labels."""
    imgs, labs = [], []
    for b in batches:
        keep = slot_of[b["label"].long()] >= 0
        if keep.any():
            imgs.append(b["image"][keep])
            labs.append(b["label"].long()[keep])
    if not imgs:
        return
    img, lab = torch.cat(imgs), torch.cat(labs)
    for s in range(0, len(lab), block):
        yield img[s:s + block], lab[s:s + block]
