"""The port's fused FFN (plain versions, the CPU path of the kernels) against
the JAX package's ``fused_mlp`` in interpret mode: the forward and the
gradients of x, w1, b1, w2 and b2, with and without dropout, on the same
numpy inputs and the same int32 seed. The rows (2 x 17 = 34) are not a
multiple of any row tile.

Tolerances, and why: fp32 forward rtol/atol 1e-5 and gradients rtol 1e-4 /
atol 1e-4 of max |ref| (fp32 summation order over the rows and the hidden
width); bf16 2e-2 of max |ref| (a few bf16 ulps where an fp32 difference in
the last bit flips a rounding of h, dh or the weight-gradient sums). The
weight gradients reach the fp32 parameters rounded to the compute dtype in
both (JAX casts the weights outside its kernel); the bf16 case checks that
they are bf16 values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schemanet_torch.ops.kernels import mlp as mk
from schemanet_tpu.ops.pallas.mlp import _erf as jax_erf
from schemanet_tpu.ops.pallas.mlp import fused_mlp as jax_fused_mlp

SEED = 2**31 - 2
BS, N, DIM, F = 2, 17, 16, 64


# (bs, n, dim, f) beside the narrow default: DeiT-Small's and DeiT-Base's
# widths (the CUDA wide route), a few rows
WIDE = {"d384": (1, 9, 384, 1536), "d768": (1, 5, 768, 3072)}


def _inputs(seed=0, bs=BS, n=N, dim=DIM, f=F):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.normal(size=(bs, n, dim)).astype(np.float32),
        w1=(rng.normal(size=(dim, f)) * (dim**-0.5 * 1.2)).astype(np.float32),  # JAX [in, out]
        b1=(rng.normal(size=(f,)) * 0.1).astype(np.float32),
        w2=(rng.normal(size=(f, dim)) * (f**-0.5 * 1.6)).astype(np.float32),
        b2=(rng.normal(size=(dim,)) * 0.1).astype(np.float32),
    )


def _jax(inp, jdt, p):
    kw = dict(dropout_p=p, seed=SEED) if p else {}
    x = jnp.asarray(inp["x"]).astype(jdt)
    params = {k: jnp.asarray(inp[k]) for k in ("w1", "b1", "w2", "b2")}

    def run(x_, prm):
        return jax_fused_mlp(x_, prm["w1"], prm["b1"], prm["w2"], prm["b2"], interpret=True, **kw)

    def loss(x_, prm):
        return jnp.sum(jnp.sin(run(x_, prm).astype(jnp.float32)))

    gx, gp = jax.grad(loss, argnums=(0, 1))(x, params)
    out = {"out": run(x, params), "x": gx, "w1": gp["w1"].T, "b1": gp["b1"], "w2": gp["w2"].T,
           "b2": gp["b2"]}
    return {k: np.asarray(v.astype(jnp.float32)) for k, v in out.items()}


def _torch(inp, dtype, p):
    x = torch.from_numpy(inp["x"]).to(dtype).requires_grad_()
    params = {  # nn.Linear layout [out, in], fp32 parameters
        "w1": torch.from_numpy(inp["w1"].T.copy()), "b1": torch.from_numpy(inp["b1"]),
        "w2": torch.from_numpy(inp["w2"].T.copy()), "b2": torch.from_numpy(inp["b2"]),
    }
    for t in params.values():
        t.requires_grad_()
    out = mk.fused_mlp(x, params["w1"], params["b1"], params["w2"], params["b2"],
                       dropout_p=p, seed=SEED if p else None)
    torch.sin(out.float()).sum().backward()
    got = {"out": out.detach(), "x": x.grad, **{k: t.grad for k, t in params.items()}}
    return {k: v.float().numpy() for k, v in got.items()}


@pytest.mark.parametrize("dtype,p,shape", [
    pytest.param(dtype, p, shape, id=f"dtype{i}-{p}" + (f"-{shape}" if shape else ""))
    for shape in (None, *WIDE) for i, dtype in enumerate((torch.float32, torch.bfloat16))
    for p in (0.0, 0.1)
])
def test_fused_mlp_matches_jax(dtype, p, shape):
    """The narrow default (34 rows of 16 -> 64), and DeiT-Small's and
    DeiT-Base's widths on a few rows: the mask the same bits as JAX's (a
    wrong mask is an O(1) error at p = 0.1)."""
    inp = _inputs() if shape is None else _inputs(0, *WIDE[shape])
    want = _jax(inp, jnp.float32 if dtype == torch.float32 else jnp.bfloat16, p)
    got = _torch(inp, dtype, p)
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        if dtype == torch.float32:
            tol = 1e-5 if name == "out" else 1e-4
            np.testing.assert_allclose(got[name], w, rtol=tol, atol=tol * max(1.0, np.abs(w).max()),
                                       err_msg=name)
        else:
            assert np.abs(got[name] - w).max() <= 2e-2 * np.abs(w).max(), name
    if dtype == torch.bfloat16:  # the fp32 weight gradients hold bf16 values
        for name in ("w1", "b1", "w2", "b2"):
            g = torch.from_numpy(got[name])
            assert torch.equal(g, g.to(torch.bfloat16).float()), name


def test_gelu_is_the_kernels_erf_not_torch_erf():
    """The erf of the TPU kernel, which F.gelu's is not: equal to within two
    fp32 ulps at 1 (the frameworks' exp may differ in the last bit)."""
    x = np.linspace(-6, 6, 20001, dtype=np.float32)
    want = np.asarray(jax_erf(jnp.asarray(x)))
    np.testing.assert_allclose(mk.erf_as(torch.from_numpy(x)).numpy(), want, rtol=0, atol=2.4e-7)
    xt = torch.from_numpy(x)
    assert not torch.equal(mk.gelu_as(xt), torch.nn.functional.gelu(xt))


@pytest.mark.parametrize("p", [0.0, 0.3])
def test_bwd_reference_is_the_gradient_of_the_forward(p):
    """The plain backward (the one the kernel is held against) equals
    autograd of the plain forward in fp32."""
    inp = _inputs(1)
    x = torch.from_numpy(inp["x"]).requires_grad_()
    w1, w2 = torch.from_numpy(inp["w1"].T.copy()), torch.from_numpy(inp["w2"].T.copy())
    b1, b2 = torch.from_numpy(inp["b1"]), torch.from_numpy(inp["b2"])
    ws = [t.clone().requires_grad_() for t in (w1, b1, w2, b2)]
    g = torch.from_numpy(np.random.default_rng(3).normal(size=(BS, N, DIM)).astype(np.float32))
    mk.fused_mlp_reference(x, *ws, dropout_p=p, seed=SEED).backward(g)
    got = mk.fused_mlp_bwd_reference(x.detach(), w1, b1, w2, g, dropout_p=p, seed=SEED)
    for a, b in zip(got, [x.grad] + [t.grad for t in ws]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,dim,f,route", [
    (torch.bfloat16, 192, 768, "tensor_core"),  # DeiT-Tiny, stage 0
    (torch.bfloat16, 64, 96, "tensor_core"),  # f past a hidden chunk of 64
    (torch.bfloat16, 128, 8, "tensor_core"),
    (torch.bfloat16, 256, 1024, "tensor_core"),
    (torch.float32, 192, 768, "fma"),  # the fp32 stage-0 checks
    (torch.float32, 64, 100, "fma"),  # fp32 takes any f
    (torch.bfloat16, 192, 40, "tensor_core"),  # f past the forward's hidden chunk of 32
    (torch.bfloat16, 64, 16, "tensor_core"),  # f under one chunk
    (torch.float32, 256, 768, "fma"),
    (torch.bfloat16, 384, 1536, "tensor_core"),  # DeiT-Small, the wide route
    (torch.bfloat16, 768, 3072, "tensor_core"),  # DeiT-Base, the wide route
    (torch.float32, 384, 1536, "fma"),
    (torch.float32, 768, 3072, "fma"),
])
def test_mlp_route(dtype, dim, f, route):
    """The CUDA kernels a fused_mlp (forward) or fused_mlp_bwd launch takes,
    the same for both: bf16 the tensor-core kernels at every width the FMA
    kernels take, fp32 the FMA kernels."""
    assert mk.mlp_route(dtype, dim, f) == route


@pytest.mark.parametrize("dtype,dim,f,what", [
    (torch.bfloat16, 192, 100, "multiple of 8"),
    (torch.bfloat16, 192, 0, "multiple of 8"),
    (torch.bfloat16, 320, 1280, "width"),  # between the widths the kernels take
    (torch.float32, 48, 96, "width"),
    (torch.bfloat16, 192, 12, "multiple of 8"),  # the forward copies 16-byte chunks too
    (torch.bfloat16, 1024, 4096, "width"),  # past DeiT-Base's 768: no config names it
])
def test_mlp_route_rejects(dtype, dim, f, what):
    """No quiet fallback: a bf16 shape the tensor-core kernels do not take
    raises."""
    with pytest.raises(ValueError, match=what):
        mk.mlp_route(dtype, dim, f)


def test_mlp_route_rejects_other_dtypes():
    with pytest.raises(TypeError, match="float16"):
        mk.mlp_route(torch.float16, 192, 768)


@pytest.mark.parametrize("rows,dim,f", [
    (12_608, 384, 1536),  # DeiT-Small stage 0
    (12_608, 768, 3072),  # DeiT-Base stage 0
    (1000, 384, 1536),  # rows that end inside a 64-row step
    (77, 768, 3072),  # one 128-row tile, most of it past the end
])
def test_wide_plan(rows, dim, f):
    """The bf16 wide route's launch plan: the weight gradients' row splits
    depend on the shape alone and their units cover the card; no split is
    empty; the scratch covers every element the kernels write, and no fp32
    [rows, f] scratch is left (dA stays in registers)."""
    plan = mk.mlp_plan(torch.bfloat16, rows, dim, f)
    assert plan.wide and plan.route == "tensor_core"
    assert plan.splits == mk.mlp_plan(torch.bfloat16, rows, dim, f).splits
    assert plan.splits == mk.wgrad_splits(rows, dim, f)
    assert plan.units == 2 * (dim // 128) * -(-f // 128) * plan.splits >= 132
    assert plan.split_rows % 64 == 0
    assert (plan.splits - 1) * plan.split_rows < rows <= plan.splits * plan.split_rows
    for spec, writes in ((plan.bwd_scratch, plan.writes),):
        for name, (shape, dt) in spec.items():
            assert int(np.prod(shape)) >= writes[name], name
    assert plan.fwd_scratch == {"hidden": ((rows, f), torch.bfloat16)}
    assert "da" not in plan.bwd_scratch
    assert not any(dt == torch.float32 and tuple(shape[-2:]) == (rows, f)
                   for shape, dt in plan.bwd_scratch.values())
    for name, n, mn_major in (("fc2", dim, False), ("dx", dim, True)):
        mt, nt, width = plan.tiles[name]
        bm, bn = mk.gemm_tile(rows, n, mn_major)
        assert (mt, width) == (-(-rows // bm), bn) and nt * width >= n > (nt - 1) * width, name
    for name, n, bm in (("fc1", f, 192), ("h_da", f, 128)):
        mt, nt, width = plan.tiles[name]
        assert mt == -(-rows // bm) and nt * width >= n > (nt - 1) * width, name


@pytest.mark.parametrize("rows,n,mn_major,tile", [
    (12_608, 384, False, (192, 192)),  # fc2 at 384: 132 tiles, one round
    (12_608, 768, False, (192, 192)),  # fc2 at 768 (and ffn_block's fc2): ties 128 x 192
    (12_608, 384, True, (192, 192)),  # dx at 384
    (12_608, 768, True, (192, 192)),  # dx at 768
    (1000, 384, False, (128, 96)),  # 32 tiles: one round either way, the smallest
    (1000, 384, True, (128, 128)),
])
def test_gemm_tile(rows, n, mn_major, tile):
    """The tile of the wide route's products with a light epilogue
    (csrc/gemm.cuh gemm_tile); fc1's is 192 x 128 at every shape."""
    assert mk.gemm_tile(rows, n, mn_major) == tile
    assert mk.mlp_plan(torch.bfloat16, rows, 384, 1536).tiles["fc1"] == (-(-rows // 192), 12, 128)


@pytest.mark.parametrize("dtype,rows,dim,f", [
    (torch.float32, 12_608, 384, 1536),  # the fp32 wide route keeps its dA scratch
    (torch.bfloat16, 12_608, 192, 768),  # DeiT-Tiny: the one-launch route, 12 splits
    (torch.float32, 1000, 192, 768),
])
def test_plan_other_routes(dtype, rows, dim, f):
    """The fp32 wide route and the one-launch routes keep their scratch and
    splits: fp32 dA [rows, f] on the fp32 wide route only, the bf16
    narrow route's 12 fixed splits of 32-row steps."""
    plan = mk.mlp_plan(dtype, rows, dim, f)
    assert ("da" in plan.bwd_scratch) == (dim > 256 and dtype == torch.float32)
    assert ("hidden" in plan.fwd_scratch) == (dim > 256)
    for name, (shape, dt) in plan.bwd_scratch.items():
        assert int(np.prod(shape)) >= plan.writes[name], name
    if dtype == torch.bfloat16:
        assert plan.splits == 12 and plan.bwd_scratch["hidden"] == ((2, rows, f), dtype)
    else:
        assert plan.splits == min(24, -(-rows // 32))
