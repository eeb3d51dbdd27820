"""Every kernel on the port's paths takes every width and head count that a
file under ``configs/`` names, in bf16 and fp32: the Python route and width
checks of the CUDA wrappers, which raise on what no kernel takes (there is
no fallback to a plain version on the card). The widths come from
``configs/models/*.yaml``, the inline ``model:`` blocks of
``configs/*/vanilla/*.yaml`` (ViT width d, heads, FFN width f, tokens n) and
``gnn.embed_dim`` of ``configs/*/schema_net/*.yaml`` (the GNN's width D,
with its instance graphs' V = feat_h * feat_w and class graphs'
``class_max_vertices``), each read with the JAX package's ``get_cfg``.
Needs no GPU: the checks are plain Python."""

import glob
import os
import re

import pytest
import torch

from schemanet_torch.ops.kernels import atlas_opt as ao
from schemanet_torch.ops.kernels import attention as ak
from schemanet_torch.ops.kernels import encoder_block as eb
from schemanet_torch.ops.kernels import graphconv as gc
from schemanet_torch.ops.kernels import layernorm as lnk
from schemanet_torch.ops.kernels import mlp as mk
from schemanet_torch.ops.kernels import quant as qk
from schemanet_torch.ops.kernels import vq as vqk
from schemanet_tpu.utils.config import get_cfg

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "configs")
DTYPES = (torch.bfloat16, torch.float32)


def _rel(path):
    return os.path.relpath(path, ROOT)


def _ln_check_width(dtype, d):
    """``fused_layernorm``'s width check: ``check_width``, or in a checkout
    without it the same test inline, against ``_MAX_DIM``."""
    if hasattr(lnk, "check_width"):
        return lnk.check_width(dtype, d)
    if not 0 < d <= lnk._MAX_DIM:
        raise ValueError(f"fused_layernorm takes width 1..{lnk._MAX_DIM}, got {d}")


def _vit_shapes():
    """(config, d, heads, f, n) of every ViT a model file or a vanilla
    config's inline model block names."""
    out = {}
    files = sorted(glob.glob(os.path.join(ROOT, "models", "*.yaml"))
                   + glob.glob(os.path.join(ROOT, "*", "vanilla", "*.yaml")))
    for path in files:
        model = get_cfg(path)
        model = model.get("model", model)
        t, pe = model["transformer"], model["patch_embed"]
        n = (pe["img_size"] // pe["patch_size"]) ** 2 + 1  # patches + the cls token
        out[_rel(path)] = (t["embed_dim"], t["num_heads"], t["dim_feedforward"], n)
    return out


def _gnn_shapes():
    """(config, D, [V]) of every SchemaNet config's GNN."""
    out = {}
    for path in sorted(glob.glob(os.path.join(ROOT, "*", "schema_net", "*.yaml"))):
        sn = get_cfg(path)["schema_net"]
        atlas = sn.get("ir_atlas", {})
        vs = [atlas["feat_h"] * atlas["feat_w"]]
        if atlas.get("class_max_vertices"):
            vs.append(atlas["class_max_vertices"])
        out[_rel(path)] = (sn["gnn"]["embed_dim"], vs)
    return out


def _atlas_widths():
    """(config, V) of every SchemaNet config's atlas: ``class_max_vertices``,
    or the codebook's M (the file's ``M_<n>``) where it is null."""
    out = {}
    for path in sorted(glob.glob(os.path.join(ROOT, "*", "schema_net", "*.yaml"))):
        v = get_cfg(path)["schema_net"].get("ir_atlas", {}).get("class_max_vertices")
        out[_rel(path)] = v or int(re.search(r"M_(\d+)", os.path.basename(path)).group(1))
    return out


VITS, GNNS, ATLASES = _vit_shapes(), _gnn_shapes(), _atlas_widths()


def test_the_configs_name_the_widths_this_checks():
    """The configs' ViT and GNN widths: DeiT-Tiny, -Small and -Base (d 192,
    384, 768 with f = 4 d) and the GNN's 256 and 1024."""
    assert {d for d, *_ in VITS.values()} == {192, 384, 768}
    assert all(f == 4 * d for d, _, f, _ in VITS.values())
    assert {d for d, _ in GNNS.values()} == {256, 1024}


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp32"])
@pytest.mark.parametrize("config", sorted(VITS))
def test_vit_kernels_take_the_config(config, dtype):
    """attn_block (the frozen layers), ffn_block, fused_mhsa and fused_mlp
    (stage 0), the LayerNorm (stage 0's), vq_assign (stages 1, 3 and
    serving) and the int8 route's quantize_rows and int8_gemm (the
    projections' input widths d and f) at the config's widths: each
    returns a route and raises nothing."""
    d, heads, f, n = VITS[config]
    assert eb.attn_block_route(dtype, n, heads, d // heads)
    assert eb.ffn_block_route(dtype, d, f)
    assert ak.mhsa_route(dtype, n, d // heads)
    assert mk.mlp_route(dtype, d, f)
    _ln_check_width(dtype, d)
    assert vqk.vq_route(dtype, d)
    for k in (d, f):
        qk.check_row_width(dtype, k)
        qk.check_k(k)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp32"])
@pytest.mark.parametrize("config", sorted(GNNS))
def test_gnn_kernels_take_the_config(config, dtype):
    """sym_conv (forward and backward: one route) on the instance and class
    graphs, and the GNN's fused LayerNorm (+relu), at the config's width."""
    width, vs = GNNS[config]
    for v in vs:
        assert gc.conv_route(dtype, v, width)
    _ln_check_width(dtype, width)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp32"])
@pytest.mark.parametrize("config", sorted(VITS))
def test_ffn_plan_takes_the_config(config, dtype):
    """ffn_block's launch plan at the config's widths and a serving
    microbatch of 64 images: past 384 every scratch it allocates is named
    with its shape, and the bf16 wide route's products have tiles."""
    d, _, f, n = VITS[config]
    plan = eb.ffn_plan(dtype, 64 * n, d, f)
    assert plan.wide == (d > 384) and len(plan.launches) == (3 if plan.wide else 1)
    if plan.wide:
        assert plan.scratch["hidden"] == ((64 * n, f), dtype)
        assert (dtype == torch.bfloat16) == bool(plan.tiles)


@pytest.mark.parametrize("config", sorted(ATLASES))
def test_adamw_plan_takes_the_config(config):
    """adamw_project_rows at the config's atlas width: the edge rows [K V,
    V] and vertex rows [K, V] take a warp a row in pieces of 4 columns (V a
    multiple of 4, the tensors aligned), in fp32 and bf16 moments."""
    v = ATLASES[config]
    assert v % 4 == 0 and v <= 1024
    for rows in (1000 * v, 1000):
        for mdt in DTYPES:
            plan = ao.adamw_plan(rows, v, mdt, mdt)
            assert plan.route == "vector" and plan.values_per_lane * 32 >= v


@pytest.mark.parametrize("check,args", [
    (mk.mlp_route, (torch.bfloat16, 320, 1280)),
    (eb.ffn_block_route, (torch.float32, 1024, 4096)),
    (_ln_check_width, (torch.bfloat16, 1025)),
    (qk.check_row_width, (torch.float32, 3080)),
    (qk.check_k, (48,)),
])
def test_widths_no_kernel_takes_still_raise(check, args):
    with pytest.raises(ValueError):
        check(*args)
