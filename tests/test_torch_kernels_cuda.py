"""The hand-written CUDA kernels against their plain PyTorch versions on the
card, at small shapes whose edges are not multiples of the kernels' tiles.

Needs an NVIDIA GPU and nvcc: every test carries the ``cuda`` marker and skips
without a card. Imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

Tolerances, relative to max |plain|: fp32 1e-5 (summation order only), bf16
2e-2 (a few bf16 ulps where roundings meet in another order). The fused attention and FFN kernels
are held to the plain versions of their forward and their backward, with
dropout off and at p = 0.1 with the same seed; the FFN kernels also with
relu at 192, 384 and 768 and with the forward-only activations at 384. The
relu backward is held in lock step: the plain version takes the kernel's
relu gate, read back from the kernel (``tests/_torch_relu_gates.py``), and
every gate the two set apart must lie within the fp32 summation-error bound
of the point where the gate switches (``gate_candidates``).

The VQ kernel (fp32 by the 3xTF32 split, bf16 by bf16 mma, both counted by
``tc_launches``) sums each dot product in another order than the plain
version's matrix product: its ids must equal the plain ones on >= 99.9% of
rows, every mismatch a near-tie (the plain scores of the two codes within
1e-5 of the row's largest |score|), and duplicated codes give the first
index exactly. The LayerNorm kernels: the forward within the tolerances
above, the backward's dx too (fp32 1e-4: the statistics are recomputed),
dscale and dbias within 1e-4 in both dtypes (fp32 sums) and equal bit for
bit from run to run, on both of the backward's routes (16-byte and
scalar pieces). ``embed_grad`` at its edges (a long id, an id spanning
chunks, unused ids that must be exact zeros, one table row) within 1e-5 and
bitwise from run to run; a planned call runs under the sync debug mode
"error" and a plan is rebuilt after an in-place write. The bf16 FFN
backward's weight and bias gradients are equal bit for bit over two calls
too. The image pipeline's ``crop_resize`` and ``ycc_to_rgb`` equal their
plain versions bit for bit (the same operations in the same order;
``ycc_to_rgb`` at every chroma mode), and
the nvJPEG route's pixels lie within 3 levels of libjpeg's on the JPEG
fixtures (mean under 0.2 a byte: nvJPEG's IDCT). The int8 route's
``quantize_rows`` and ``int8_gemm`` equal their plain versions bit for bit
(the same IEEE divisions and rounding, exact int32 sums, the same fp32
epilogue in the same order).
"""

import pytest
import torch

from schemanet_torch.ops.kernels import atlas_opt as ao
from schemanet_torch.ops.kernels import attention as ak
from schemanet_torch.ops.kernels import embed_bwd as ek
from schemanet_torch.ops.kernels import encoder_block as eb
from schemanet_torch.ops.kernels import graphconv as gc
from schemanet_torch.ops.kernels import imagepipe as ipk
from schemanet_torch.ops.kernels import layernorm as lnk
from schemanet_torch.ops.kernels import mlp as mk
from schemanet_torch.ops.kernels import quant as qk
from schemanet_torch.ops.kernels import vq as vqk
from tests._torch_relu_gates import gate_flips, kernel_gate

pytestmark = pytest.mark.cuda
TOLS = [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rnd(g, dev, *shape, scale=1.0):
    return (torch.randn(*shape, generator=g) * scale).to(dev)


def _rel(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("bs,n,dim,heads", [
    (3, 37, 64, 2), (2, 70, 192, 3),
    (5, 65, 192, 3),  # one query row past a tile of 64
    (2, 197, 384, 6),  # DeiT-Small's width and heads
])
def test_attn_block_kernel(dev, dtype, tol, bs, n, dim, heads):
    """bf16 takes the tensor-core route: the qkv and out products by mma,
    the attention by fused_mhsa's kernel at p = 0 and its head-mean variant;
    fp32 the split-TF32 route (products by three TF32 mma, the attention's
    softmax online over chunks of 32 keys). Both are counted by
    tc_launches."""
    g = torch.Generator().manual_seed(0)
    x = _rnd(g, dev, bs, n, dim).to(dtype)
    args = (
        x, 1 + _rnd(g, dev, dim, scale=0.1), _rnd(g, dev, dim, scale=0.1),
        _rnd(g, dev, 3 * dim, dim, scale=dim**-0.5), _rnd(g, dev, 3 * dim, scale=0.1),
        _rnd(g, dev, dim, dim, scale=dim**-0.5), _rnd(g, dev, dim, scale=0.1), heads,
    )
    before = (eb.attn_block.launches, eb.attn_block.hmean_launches, eb.attn_block.tc_launches)
    out, hmean = eb.attn_block(*args, capture_hmean=True)
    plain_only = eb.attn_block(*args)
    want_out, want_hmean = eb.attn_block_reference(*args, capture_hmean=True)
    torch.cuda.synchronize()
    assert (eb.attn_block.launches, eb.attn_block.hmean_launches, eb.attn_block.tc_launches) == \
        (before[0] + 2, before[1] + 1, before[2] + 2)
    assert out.dtype == hmean.dtype == dtype and hmean.shape == (bs, n, n)
    assert _rel(out, want_out) <= tol and _rel(hmean, want_hmean) <= tol
    assert torch.equal(plain_only, out)  # the head-mean output changes nothing else


@pytest.mark.parametrize("bs,n,dim,heads", [
    (3, 33, 90, 3),  # head_dim 30: 4-byte copies, padded to 32
    (2, 50, 80, 2),  # head_dim 40, padded to 64
    (2, 400, 256, 2),  # head_dim 128, n past several key chunks and query tiles
    (1, 5, 8, 8),  # head_dim 1, fewer rows than a warp's 16
])
def test_attn_block_fp32_edges(dev, bs, n, dim, heads):
    """The fp32 route at head_dims and widths off its tiles: within 1e-5 of
    the plain version, both variants, counted on the tensor cores, and the
    same bits over two calls."""
    g = torch.Generator().manual_seed(2)
    args = (
        _rnd(g, dev, bs, n, dim), 1 + _rnd(g, dev, dim, scale=0.1), _rnd(g, dev, dim, scale=0.1),
        _rnd(g, dev, 3 * dim, dim, scale=dim**-0.5), _rnd(g, dev, 3 * dim, scale=0.1),
        _rnd(g, dev, dim, dim, scale=dim**-0.5), _rnd(g, dev, dim, scale=0.1), heads,
    )
    assert eb.attn_block_route(torch.float32, n, heads, dim // heads) == "split_tf32"
    before = eb.attn_block.tc_launches
    out, hmean = eb.attn_block(*args, capture_hmean=True)
    out2, hmean2 = eb.attn_block(*args, capture_hmean=True)
    want_out, want_hmean = eb.attn_block_reference(*args, capture_hmean=True)
    torch.cuda.synchronize()
    assert eb.attn_block.tc_launches == before + 2
    assert _rel(out, want_out) <= 1e-5 and _rel(hmean, want_hmean) <= 1e-5
    assert torch.equal(out, out2) and torch.equal(hmean, hmean2)
    assert torch.equal(eb.attn_block(*args), out)


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("rows,dim,f", [
    (45, 64, 96), (2 * 197, 192, 768),
    (70, 128, 96),  # f past a hidden chunk of 32
    (1000, 256, 1024),  # rows past a row tile of 64 (bf16) and 32 (fp32 at 256)
    (2 * 197, 384, 1536),  # DeiT-Small: 32 rows a block; fp32 in hidden chunks of 16
    (45, 384, 104),  # f past a hidden chunk of 16 (fp32 at 384)
])
def test_ffn_block_kernel(dev, dtype, tol, rows, dim, f):
    """bf16 takes the tensor-core kernel, fp32 the split-TF32 kernel, both
    counted by tc_launches."""
    g = torch.Generator().manual_seed(1)
    args = (
        _rnd(g, dev, 1, rows, dim).to(dtype), 1 + _rnd(g, dev, dim, scale=0.1),
        _rnd(g, dev, dim, scale=0.1), _rnd(g, dev, f, dim, scale=dim**-0.5),
        _rnd(g, dev, f, scale=0.1), _rnd(g, dev, dim, f, scale=f**-0.5), _rnd(g, dev, dim, scale=0.1),
    )
    before = (eb.ffn_block.launches, eb.ffn_block.tc_launches)
    got = eb.ffn_block(*args)
    torch.cuda.synchronize()
    assert eb.ffn_block_route(dtype, dim, f) == ("tensor_core" if dtype == torch.bfloat16
                                                 else "split_tf32")
    assert (eb.ffn_block.launches, eb.ffn_block.tc_launches) == (before[0] + 1, before[1] + 1)
    assert got.dtype == dtype
    assert _rel(got, eb.ffn_block_reference(*args)) <= tol


@pytest.mark.parametrize("rows", [12_608, 1000, 77])
def test_ffn_block_wide_bf16(dev, rows):
    """DeiT-Base's width in bf16: the LN pass, fc1 + gelu and fc2 + residual
    by the TMA-fed wgmma GEMM (12,608 rows: the serving microbatch; 77 leave
    most of a 192-row tile past the end). Within 2e-2 of the plain version,
    the same bits over two calls, and the LN pass's output bit for bit its
    plain emulation's (computed on the CPU)."""
    dim, f = 768, 3072
    g = torch.Generator().manual_seed(2)
    args = (
        _rnd(g, dev, 1, rows, dim).to(torch.bfloat16), 1 + _rnd(g, dev, dim, scale=0.1),
        _rnd(g, dev, dim, scale=0.1), _rnd(g, dev, f, dim, scale=dim**-0.5),
        _rnd(g, dev, f, scale=0.1), _rnd(g, dev, dim, f, scale=f**-0.5), _rnd(g, dev, dim, scale=0.1),
    )
    before = eb.ffn_block.wide_launches
    got = eb.ffn_block(*args)
    torch.cuda.synchronize()
    assert eb.ffn_block.wide_launches == before + 1
    assert eb.ffn_plan(torch.bfloat16, rows, dim, f).launches[0] == "ln_rows_bf16_kernel"
    assert _rel(got, eb.ffn_block_reference(*args)) <= 2e-2
    assert torch.equal(got, eb.ffn_block(*args))
    ln = eb.ffn_ln_rows(*args[:3])
    assert torch.equal(ln.cpu(), eb.ln_rows_reference(*(t.cpu() for t in args[:3]), 1e-6))


# rows of E 4-byte aligned (V = 70), 8-byte (196: instance graphs; 500:
# ImageNet class graphs), 16-byte (1024: CIFAR class graphs), 2-byte (33)
CONV_SHAPES = [(2, 70, 40), (3, 196, 256), (2, 500, 1024), (2, 1024, 256), (2, 33, 8)]


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("k,v,d", CONV_SHAPES)
def test_sym_conv_kernel(dev, dtype, tol, k, v, d):
    """bf16 takes the tensor-core kernel (counted by tc_launches), fp32 the
    FMA one; the identity on the diagonal tiles shows as an O(1) error if a
    fragment's coordinates are wrong."""
    g = torch.Generator().manual_seed(2)
    e = (torch.rand(k, v, v, generator=g) / v).to(dev, dtype)
    f = _rnd(g, dev, k, v, d).to(dtype)
    before = (gc.sym_conv.launches, gc.sym_conv.tc_launches)
    got = gc.sym_conv(e, f)
    torch.cuda.synchronize()
    tc = int(dtype == torch.bfloat16)
    assert (gc.sym_conv.launches, gc.sym_conv.tc_launches) == (before[0] + 1, before[1] + tc)
    assert got.dtype == dtype and got.shape == (k, v, d)
    assert _rel(got, gc.sym_conv_reference(e, f)) <= tol


def test_kernels_reject_bad_inputs(dev):
    x = torch.zeros(2, 5, 64, device=dev, dtype=torch.float16)
    w = torch.zeros(192, 64, device=dev)
    with pytest.raises(TypeError):
        eb.attn_block(x, w[0], w[0], w, w[:, 0], w[:64], w[0], 2)
    e = torch.zeros(2, 8, 8, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        gc.sym_conv(e.transpose(1, 2), torch.zeros(2, 8, 4, device=dev))
    with pytest.raises(ValueError, match="multiple of 8"):  # no quiet fallback to the FMA kernel
        gc.sym_conv(e.bfloat16(), torch.zeros(2, 8, 12, device=dev, dtype=torch.bfloat16))


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("k,v,d", CONV_SHAPES)
def test_sym_conv_bwd_kernel(dev, dtype, tol, k, v, d):
    """bf16: the tensor-core kernels, dE computed on the upper triangle of
    tiles and mirrored, so exactly symmetric; fp32: the FMA kernels."""
    g = torch.Generator().manual_seed(3)
    e = (torch.rand(k, v, v, generator=g) / v).to(dev, dtype)
    f, cot = _rnd(g, dev, k, v, d).to(dtype), _rnd(g, dev, k, v, d).to(dtype)
    before = (gc.sym_conv_bwd.launches, gc.sym_conv_bwd.tc_launches)
    de, df = gc.sym_conv_bwd(e, f, cot)
    no_de, df_only = gc.sym_conv_bwd(e, f, cot, need_de=False)
    want_de, want_df = gc.sym_conv_bwd_reference(e, f, cot)
    torch.cuda.synchronize()
    tc = 2 * int(dtype == torch.bfloat16)
    assert (gc.sym_conv_bwd.launches, gc.sym_conv_bwd.tc_launches) == \
        (before[0] + 2, before[1] + tc)
    assert de.dtype == df.dtype == dtype and de.shape == (k, v, v) and no_de is None
    assert _rel(de, want_de) <= tol and _rel(df, want_df) <= tol
    assert torch.equal(df_only, df)
    if dtype == torch.bfloat16:
        assert torch.equal(de, de.transpose(1, 2))
    # through autograd: the Function's backward launches the kernel
    ef, ff = e.clone().requires_grad_(), f.clone().requires_grad_()
    gc.sym_conv(ef, ff).backward(cot)
    assert _rel(ef.grad, want_de) <= tol and _rel(ff.grad, want_df) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,num_rows,d", [((5, 37), 40, 24), ((100, 1024), 1025, 256)])
def test_embed_grad_kernel(dev, dtype, shape, num_rows, d):
    g = torch.Generator().manual_seed(4)
    ids = torch.randint(0, num_rows, shape, generator=g, dtype=torch.int32)
    ids[0] = num_rows - 1  # one id many times over
    ids = ids.to(dev)
    cot = _rnd(g, dev, *shape, d).to(dtype)
    got = ek.embed_grad(ids, cot, num_rows)
    want = ek.embed_grad_reference(ids, cot, num_rows)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (num_rows, d)
    assert _rel(got, want) <= 1e-5
    # both add in a fixed order: the same bits on every call
    assert torch.equal(got, ek.embed_grad(ids, cot, num_rows))
    assert torch.equal(want, ek.embed_grad_reference(ids, cot, num_rows))


# (ids, num_rows) of the embed_grad edge cases: one id taking 4,096 rows and
# more, one id spanning several chunks of 32 sorted positions, ids that no
# row takes (their table rows must be exact zeros), a table of one row
EMBED_EDGES = {
    "long_id": (lambda g: torch.cat([torch.zeros(4500, dtype=torch.int32),
                                     torch.randint(1, 9, (500,), generator=g,
                                                   dtype=torch.int32)]), 9),
    "spanning": (lambda g: torch.randint(0, 3, (700,), generator=g, dtype=torch.int32), 3),
    "unused": (lambda g: torch.randint(0, 5, (300,), generator=g, dtype=torch.int32) * 3, 16),
    "one_row": (lambda g: torch.zeros(77, dtype=torch.int32), 1),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,d", [("long_id", 256), ("spanning", 40), ("unused", 24),
                                    ("one_row", 6)])
def test_embed_grad_kernel_edges(dev, dtype, case, d):
    g = torch.Generator().manual_seed(9)
    make, num_rows = EMBED_EDGES[case]
    ids = make(g).to(dev)
    cot = _rnd(g, dev, ids.numel(), d).to(dtype)
    got = ek.embed_grad(ids, cot, num_rows)
    want = ek.embed_grad_reference(ids, cot, num_rows)
    torch.cuda.synchronize()
    assert _rel(got, want) <= 1e-5
    assert torch.equal(got, ek.embed_grad(ids, cot, num_rows))
    unused = torch.ones(num_rows, dtype=torch.bool, device=dev)
    unused[ids.long()] = False
    assert not got[unused].any()


def test_embed_grad_planned_calls(dev):
    """A planned call makes no host wait (it runs under the sync debug mode
    "error"), gives the unplanned call's bits, and after an in-place write to
    the buffer the plan is rebuilt and the result follows the new ids."""
    g = torch.Generator().manual_seed(10)
    buf = torch.arange(64, dtype=torch.int32).repeat(20).to(dev)
    cot = _rnd(g, dev, buf.numel(), 256).to(torch.bfloat16)
    plans = ek.PlannedIds()
    want = ek.embed_grad(buf, cot, 65)
    plan = plans.plan(buf, 65)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ek.embed_grad(buf, cot, 65, plan=plans.plan(buf, 65))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got, want)
    buf[:100] = 64
    assert plans.plan(buf, 65) is not plan
    got = ek.embed_grad(buf, cot, 65, plan=plans.plan(buf, 65))
    assert torch.equal(got, ek.embed_grad(buf, cot, 65))
    assert _rel(got, ek.embed_grad_reference(buf, cot, 65)) <= 1e-5


@pytest.mark.parametrize("shape,remove_self_loop", [((7, 40), False), ((6, 100, 100), True)])
def test_adamw_project_rows_kernel(dev, shape, remove_self_loop):
    g = torch.Generator().manual_seed(5)
    p = torch.rand(shape, generator=g).to(dev)
    p[0] = -1.0  # a row that projects to zero
    grad = _rnd(g, dev, *shape, scale=0.05)
    m, v = _rnd(g, dev, *shape, scale=0.01), torch.rand(shape, generator=g).to(dev) * 1e-4
    kw = dict(lr=1e-3, weight_decay=5e-4, remove_self_loop=remove_self_loop)
    want = ao.adamw_project_rows_reference(p.clone(), grad, m.clone(), v.clone(), 2, **kw)
    got = ao.adamw_project_rows(p, grad, m, v, 2, **kw)
    torch.cuda.synchronize()
    assert got[0] is p and got[1] is m and got[2] is v  # in place
    for a, b in zip(got, want):
        assert _rel(a, b) <= 1e-5
    assert not p[0].any()


def _within_bf16_ulp(got, want, terms):
    """|got - want| <= one bf16 ulp of the larger, beyond the fp32 rounding
    of the moment's sum b t + (1 - b) x (2^-22 of its terms' magnitudes):
    chip_smoke.py phase 24's rule for bf16 moments."""
    big = torch.maximum(got.float().abs(), want.float().abs()).clamp_min(1e-30)
    tol = torch.exp2(torch.floor(torch.log2(big)) - 7) + 2.0**-22 * terms
    return bool(((got.float() - want.float()).abs() <= tol).all())


BF = torch.bfloat16


# (shape, moment dtype, project, remove_self_loop, route): the ImageNet edge
# and vertex rows (V = 500, bf16 moments), CIFAR's (V = 1024, fp32), C = 70
# on the scalar route, C = 4096 on the block route, one row, plain AdamW
# (no projection), and the self loops of [K, V, V] edge rows
@pytest.mark.parametrize("shape,mdt,project,loop,route", [
    ((500_000, 500), BF, True, False, "vector"),
    ((102_400, 1024), torch.float32, True, False, "vector"),
    ((1000, 500), BF, True, False, "vector"),
    ((100, 1024), torch.float32, True, False, "vector"),
    ((333, 70), BF, True, False, "scalar"),
    ((300, 70), torch.float32, True, False, "scalar"),
    ((37, 4096), torch.float32, True, False, "block"),
    ((1, 500), BF, True, False, "vector"),
    ((1000, 500), BF, False, False, "vector"),
    ((6, 500, 500), BF, True, True, "vector"),
])
def test_adamw_project_rows_routes(dev, shape, mdt, project, loop, route):
    """The warp-a-row kernel (pieces of 4 columns or 1) and the block route
    against the plain version: p within 1e-5 of max |p|, bf16 m and v within
    one bf16 ulp beyond the fp32 rounding of their sums (fp32 ones within
    1e-5), every output the same bits over two calls, in place."""
    g = torch.Generator().manual_seed(6)
    p0 = torch.rand(shape, generator=g).to(dev)
    p0 /= p0.sum(-1, keepdim=True)
    p0[0, ..., :7] = -1.0  # negative entries that the projection clamps
    grad = _rnd(g, dev, *shape, scale=1e-4)
    m0 = _rnd(g, dev, *shape, scale=1e-5).to(mdt)
    v0 = (_rnd(g, dev, *shape, scale=1e-5) ** 2).to(mdt)
    kw = dict(lr=1e-3, weight_decay=5e-4, project=project, remove_self_loop=loop)
    plan = ao.adamw_plan(p0.numel() // shape[-1], shape[-1], mdt, mdt, p0.data_ptr(),
                         grad.data_ptr(), m0.data_ptr(), v0.data_ptr())
    assert plan.route == route
    outs = []
    for fn in (ao.adamw_project_rows, ao.adamw_project_rows, ao.adamw_project_rows_reference):
        p, m, v = p0.clone(), m0.clone(), v0.clone()
        before = ao.adamw_project_rows.vec_launches
        got = fn(p, grad, m, v, 3, **kw)
        assert got[0] is p and got[1] is m and got[2] is v
        if fn is ao.adamw_project_rows:
            assert ao.adamw_project_rows.vec_launches - before == (route == "vector")
        outs.append((p, m, v))
    torch.cuda.synchronize()
    (pk, mk_, vk), (pk2, mk2, vk2), (pp, mp, vp) = outs
    assert all(torch.equal(a, b) for a, b in ((pk, pk2), (mk_, mk2), (vk, vk2)))
    assert _rel(pk, pp) <= 1e-5
    if mdt == BF:
        assert _within_bf16_ulp(mk_, mp, 0.9 * m0.float().abs() + 0.1 * grad.abs())
        assert _within_bf16_ulp(vk, vp, 0.999 * v0.float().abs() + 0.001 * grad * grad)
    else:
        assert _rel(mk_, mp) <= 1e-5 and _rel(vk, vp) <= 1e-5
    if loop:
        assert not torch.diagonal(pk, dim1=-2, dim2=-1).any()
    if project:
        assert (pk >= 0).all()


def test_training_kernels_reject_bad_inputs(dev):
    ids = torch.tensor([0, 3, 5], dtype=torch.int32, device=dev)
    cot = torch.ones(3, 8, device=dev)
    with pytest.raises(IndexError, match="ids must lie"):
        ek.embed_grad(ids, cot, 5)
    with pytest.raises(IndexError, match="ids must lie"):
        ek.embed_grad(-ids, cot, 6)
    with pytest.raises(TypeError):
        ek.embed_grad(ids.long(), cot, 6)
    z = torch.zeros(2, 8, 8, device=dev)
    with pytest.raises(TypeError):
        ao.adamw_project_rows(z.double(), z.double(), z.double(), z.double(), 0, lr=1e-3)
    with pytest.raises(ValueError, match="columns"):
        w = torch.zeros(2, 5000, device=dev)
        ao.adamw_project_rows(w, w, w, w, 0, lr=1e-3)
    with pytest.raises(ValueError, match="shape"):
        gc.sym_conv_bwd(z, torch.zeros(2, 8, 4, device=dev), torch.zeros(2, 8, 5, device=dev))


SEED = 2**31 - 2


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("bs,n,heads,d", [
    (3, 37, 2, 16), (64, 197, 3, 64),  # a ragged tile; the stage-0 shape
    (5, 65, 2, 64),  # one row past a tile of 64
    (2, 320, 3, 64),  # the kernels' limit
    (96, 100, 4, 32),  # head_dim 32, several waves of blocks
])
def test_fused_mhsa_kernels(dev, dtype, tol, p, bs, n, heads, d):
    """Forward and backward kernels against the plain versions, the stage-0
    shape included; with dropout the masks are the same bits, so a wrong
    mask shows as an O(1) error. bf16 takes the tensor-core kernels, fp32
    the FMA ones."""
    g = torch.Generator().manual_seed(6)
    qkv = _rnd(g, dev, bs, n, 3 * heads * d).to(dtype)
    cot = _rnd(g, dev, bs, n, heads * d).to(dtype)
    seed = SEED if p else None
    before = (ak.fused_mhsa.launches, ak.fused_mhsa_bwd.launches)
    before_tc = (ak.fused_mhsa.tc_launches, ak.fused_mhsa_bwd.tc_launches)
    x = qkv.clone().requires_grad_()
    out = ak.fused_mhsa(x, heads, p, seed)
    out.backward(cot)
    torch.cuda.synchronize()
    assert (ak.fused_mhsa.launches, ak.fused_mhsa_bwd.launches) == (before[0] + 1, before[1] + 1)
    tc = int(dtype == torch.bfloat16)
    assert (ak.fused_mhsa.tc_launches, ak.fused_mhsa_bwd.tc_launches) == \
        (before_tc[0] + tc, before_tc[1] + tc)
    assert out.dtype == x.grad.dtype == dtype and out.shape == (bs, n, heads * d)
    assert _rel(out, ak.fused_mhsa_reference(qkv, heads, p, seed)) <= tol
    assert _rel(x.grad, ak.fused_mhsa_bwd_reference(qkv, cot, heads, p, seed)) <= tol


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("rows,dim,f", [
    (45, 64, 96),  # f past a chunk of 64
    (12_608, 192, 768),  # the stage-0 shape
    (1000, 192, 768),  # rows not a multiple of the tensor-core row tile (64)
    (300, 256, 1024),
    (77, 128, 40),  # f past the forward's hidden chunk of 32, not a multiple of it
])
def test_fused_mlp_kernels(dev, dtype, tol, p, rows, dim, f):
    """Forward and backward kernels against the plain versions at rows that
    are not a multiple of a row tile. In bf16 both take the tensor-core
    kernels (counted by tc_launches), and the backward gives the same weight
    and bias gradients, bit for bit, on a second call."""
    g = torch.Generator().manual_seed(7)
    x = _rnd(g, dev, 1, rows, dim).to(dtype)
    w1, b1 = _rnd(g, dev, f, dim, scale=dim**-0.5).to(dtype), _rnd(g, dev, f, scale=0.1).to(dtype)
    w2, b2 = _rnd(g, dev, dim, f, scale=f**-0.5).to(dtype), _rnd(g, dev, dim, scale=0.1).to(dtype)
    cot = _rnd(g, dev, 1, rows, dim).to(dtype)
    seed = SEED if p else None
    before = (mk.fused_mlp_bwd.launches, mk.fused_mlp_bwd.tc_launches)
    before_fwd = (mk.fused_mlp.launches, mk.fused_mlp.tc_launches)
    out = mk.fused_mlp(x, w1, b1, w2, b2, "gelu", p, seed)
    got = mk.fused_mlp_bwd(x, w1, b1, w2, cot, "gelu", p, seed)
    again = mk.fused_mlp_bwd(x, w1, b1, w2, cot, "gelu", p, seed)
    torch.cuda.synchronize()
    tc = int(dtype == torch.bfloat16)
    assert (mk.fused_mlp_bwd.launches, mk.fused_mlp_bwd.tc_launches) == \
        (before[0] + 2, before[1] + 2 * tc)
    assert (mk.fused_mlp.launches, mk.fused_mlp.tc_launches) == \
        (before_fwd[0] + 1, before_fwd[1] + tc)
    assert all(torch.equal(a, b) for a, b in zip(got[1:], again[1:]))  # no atomics
    assert out.dtype == dtype
    assert _rel(out, mk.fused_mlp_reference(x, w1, b1, w2, b2, "gelu", p, seed)) <= tol
    want = mk.fused_mlp_bwd_reference(x, w1, b1, w2, cot, "gelu", p, seed)
    for name, a, b in zip(("dx", "dw1", "db1", "dw2", "db2"), got, want):
        assert a.dtype == b.dtype == dtype and a.shape == b.shape, name
        assert _rel(a, b) <= tol, name


def _ffn_weights(g, dev, dtype, dim, f):
    return (_rnd(g, dev, f, dim, scale=dim**-0.5).to(dtype), _rnd(g, dev, f, scale=0.1).to(dtype),
            _rnd(g, dev, dim, f, scale=f**-0.5).to(dtype), _rnd(g, dev, dim, scale=0.1).to(dtype))


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("dim", [192, 384, 768])
def test_ffn_kernels_relu(dev, dtype, tol, dim):
    """relu, the activation of a config that names none, through every
    route of ``ffn_block`` and of the ``fused_mlp`` forward and backward
    (one-launch at 192, 384 wide for fused_mlp, 768 wide for both), dropout
    live in fused_mlp; each launch counted by ``relu_launches``."""
    g = torch.Generator().manual_seed(11)
    rows, f = 2 * 197 + 5, 4 * dim
    x = _rnd(g, dev, 1, rows, dim).to(dtype)
    ln = (1 + _rnd(g, dev, dim, scale=0.1), _rnd(g, dev, dim, scale=0.1))
    w = _ffn_weights(g, dev, dtype, dim, f)
    cot = _rnd(g, dev, 1, rows, dim).to(dtype)
    before = {k: getattr(fn, "relu_launches") for k, fn in (
        ("ffn", eb.ffn_block), ("fwd", mk.fused_mlp), ("bwd", mk.fused_mlp_bwd))}
    block = eb.ffn_block(x, *ln, *w, activation="relu")
    out = mk.fused_mlp(x, *w, "relu", 0.1, SEED)
    grads = mk.fused_mlp_bwd(x, *w[:3], cot, "relu", 0.1, SEED)
    torch.cuda.synchronize()
    assert eb.ffn_block.relu_launches == before["ffn"] + 1
    assert (mk.fused_mlp.relu_launches, mk.fused_mlp_bwd.relu_launches) == \
        (before["fwd"] + 1, before["bwd"] + 1)
    assert _rel(block, eb.ffn_block_reference(x, *ln, *w, activation="relu")) <= tol
    assert _rel(out, mk.fused_mlp_reference(x, *w, "relu", 0.1, SEED)) <= tol
    # in lock step: the plain version given the kernel's relu gate, read
    # back from the kernel; the gates the two set apart all candidates
    gate = kernel_gate(x, *w[:3])
    want = mk.fused_mlp_bwd_reference(x, *w[:3], cot, "relu", 0.1, SEED, gate=gate)
    for name, a, b in zip(("dx", "dw1", "db1", "dw2", "db2"), grads, want):
        assert _rel(a, b) <= tol, name
    flips = gate_flips(gate, x, *w[:2])
    assert flips["flips_outside_candidates"] == 0, flips


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("activation", ["swish", "sigmoid", "hard_sigmoid", "none"])
def test_ffn_kernels_other_activations(dev, dtype, tol, activation):
    """The forward-only activations at DeiT-Small's width; their backward
    raises, as the TPU kernel's."""
    g = torch.Generator().manual_seed(12)
    x = _rnd(g, dev, 1, 77, 384).to(dtype)
    ln = (1 + _rnd(g, dev, 384, scale=0.1), _rnd(g, dev, 384, scale=0.1))
    w = _ffn_weights(g, dev, dtype, 384, 1536)
    assert _rel(eb.ffn_block(x, *ln, *w, activation=activation),
                eb.ffn_block_reference(x, *ln, *w, activation=activation)) <= tol
    assert _rel(mk.fused_mlp(x, *w, activation), mk.fused_mlp_reference(x, *w, activation)) <= tol
    with pytest.raises(NotImplementedError):
        mk.fused_mlp_bwd(x, *w[:3], x, activation)


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("dim", [384, 768])
@pytest.mark.parametrize("rows", [12_608, 1000, 77])
def test_fused_mlp_wide_bf16(dev, p, dim, rows):
    """The bf16 wide route (DeiT-Small's 384, DeiT-Base's 768; TMA-fed wgmma,
    the backward's h and dA in one launch) against the plain versions at the
    stage-0 rows and at rows that end inside a 128-row tile and inside a
    64-row step; the weight and bias gradients the same bits on a second
    call (fixed splits, no atomics)."""
    dtype, tol, f = torch.bfloat16, 2e-2, 4 * dim
    g = torch.Generator().manual_seed(11)
    x = _rnd(g, dev, rows, dim).to(dtype)
    w1, b1 = _rnd(g, dev, f, dim, scale=dim**-0.5).to(dtype), _rnd(g, dev, f, scale=0.1).to(dtype)
    w2, b2 = _rnd(g, dev, dim, f, scale=f**-0.5).to(dtype), _rnd(g, dev, dim, scale=0.1).to(dtype)
    cot = _rnd(g, dev, rows, dim).to(dtype)
    seed = SEED if p else None
    before = (mk.fused_mlp.wide_launches, mk.fused_mlp_bwd.wide_launches)
    out = mk.fused_mlp(x, w1, b1, w2, b2, "gelu", p, seed)
    got = mk.fused_mlp_bwd(x, w1, b1, w2, cot, "gelu", p, seed)
    again = mk.fused_mlp_bwd(x, w1, b1, w2, cot, "gelu", p, seed)
    torch.cuda.synchronize()
    assert (mk.fused_mlp.wide_launches, mk.fused_mlp_bwd.wide_launches) == \
        (before[0] + 1, before[1] + 2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert _rel(out, mk.fused_mlp_reference(x, w1, b1, w2, b2, "gelu", p, seed)) <= tol
    want = mk.fused_mlp_bwd_reference(x, w1, b1, w2, cot, "gelu", p, seed)
    for name, a, b in zip(("dx", "dw1", "db1", "dw2", "db2"), got, want):
        assert a.dtype == b.dtype == dtype and a.shape == b.shape, name
        assert _rel(a, b) <= tol, name


def test_fused_kernels_reject_bad_inputs(dev):
    with pytest.raises(ValueError, match="head_dim"):
        ak.fused_mhsa(torch.zeros(2, 5, 3 * 128, device=dev), 1)
    with pytest.raises(ValueError, match="head_dim"):  # no quiet fallback to the FMA kernels
        ak.fused_mhsa(torch.zeros(2, 5, 3 * 40, device=dev, dtype=torch.bfloat16), 1)
    with pytest.raises(ValueError, match="seed"):
        ak.fused_mhsa(torch.zeros(2, 5, 48, device=dev), 1, dropout_p=0.1)
    x = torch.zeros(4, 48, device=dev)
    with pytest.raises(ValueError, match="width"):
        mk.fused_mlp(x, torch.zeros(96, 48, device=dev), torch.zeros(96, device=dev),
                     torch.zeros(48, 96, device=dev), torch.zeros(48, device=dev))
    bf = dict(device=dev, dtype=torch.bfloat16)
    x = torch.zeros(4, 64, **bf)
    with pytest.raises(ValueError, match="multiple of 8"):  # no quiet fallback to the FMA kernels
        mk.fused_mlp_bwd(x, torch.zeros(100, 64, **bf), torch.zeros(100, **bf),
                         torch.zeros(64, 100, **bf), x)
    with pytest.raises(ValueError, match="multiple of 8"):  # the forward too
        mk.fused_mlp(x, torch.zeros(100, 64, **bf), torch.zeros(100, **bf),
                     torch.zeros(64, 100, **bf), torch.zeros(64, **bf))
    w = torch.zeros(3 * 128, 128, **bf)
    with pytest.raises(ValueError, match="head_dim"):  # head_dim 128 in bf16
        eb.attn_block(torch.zeros(2, 5, 128, **bf), w[0].float(), w[0].float(), w, w[:, 0],
                      w[:128], w[0], 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,m,d", [(100, 64, 32), (1024, 1024, 192), (777, 8000, 384),
                                   (33, 130, 768),
                                   (1037, 1000, 192),  # N past a row tile, M past a code tile
                                   (65, 129, 40),  # d past a chunk; one code past a tile
                                   (20_000, 1024, 192)])  # one segment: no tickets
def test_vq_assign_kernel(dev, dtype, n, m, d):
    """Both routes (fp32: split TF32; bf16: mma) on every launch, counted by
    tc_launches; twice, so that the segments' tickets are left at zero."""
    g = torch.Generator().manual_seed(6)
    x, cb = _rnd(g, dev, n, d).to(dtype), _rnd(g, dev, m, d)
    before = (vqk.vq_assign_kernel.launches, vqk.vq_assign_kernel.tc_launches)
    got = vqk.vq_assign_kernel(x, cb)
    again = vqk.vq_assign_kernel(x, cb)
    want = vqk.vq_assign_reference(x, cb)
    torch.cuda.synchronize()
    assert (vqk.vq_assign_kernel.launches, vqk.vq_assign_kernel.tc_launches) == \
        (before[0] + 2, before[1] + 2)
    assert torch.equal(got, again)
    assert got.dtype == torch.int32 and got.shape == (n,)
    assert (got == want).float().mean().item() >= 0.999
    gaps, scale = vqk.score_gaps(x, cb, got, want)
    assert bool((gaps <= 1e-5 * scale).all()), (gaps, scale)


def test_vq_assign_kernel_duplicated_codes_take_the_first(dev):
    g = torch.Generator().manual_seed(7)
    base = _rnd(g, dev, 70, 192)
    cb = torch.cat([base] * 3)  # copies 70 codes apart: the code tiles of 128 cut them
    x = base[torch.randint(0, 70, (4, 7), generator=g).to(dev)] + _rnd(g, dev, 4, 7, 192,
                                                                       scale=0.01)
    got = vqk.vq_assign_kernel(x, cb)
    torch.cuda.synchronize()
    assert got.shape == (4, 7)
    assert torch.equal(got, vqk.vq_assign_reference(x, base))  # the first copy, exactly


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("rows,d,act", [(45, 64, "none"), (12_608, 192, "none"),
                                        (1000, 256, "relu"), (37, 768, "relu"),
                                        (5, 300, "none"), (12_607, 192, "none"),
                                        (33, 6, "relu")])
def test_fused_layernorm_kernels(dev, dtype, tol, rows, d, act):
    g = torch.Generator().manual_seed(8)
    x = (_rnd(g, dev, rows, d) * 2 + 0.5).to(dtype)
    scale, bias = 1 + _rnd(g, dev, d, scale=0.3), _rnd(g, dev, d, scale=0.3)
    cot = _rnd(g, dev, rows, d).to(dtype)
    before = (lnk.fused_layernorm.launches, lnk.fused_layernorm_bwd.launches)
    vec_before = lnk.fused_layernorm_bwd.vec_launches
    route = eb.piece_route(dtype, d, x.data_ptr(), cot.data_ptr())
    y = lnk.fused_layernorm(x, scale, bias, 1e-6, act)
    grads = lnk.fused_layernorm_bwd(x, scale, bias, cot, 1e-6, act)
    again = lnk.fused_layernorm_bwd(x, scale, bias, cot, 1e-6, act)
    want = lnk.fused_layernorm_reference(x, scale, bias, 1e-6, act)
    want_grads = lnk.fused_layernorm_bwd_reference(x, scale, bias, cot, 1e-6, act)
    torch.cuda.synchronize()
    assert (lnk.fused_layernorm.launches, lnk.fused_layernorm_bwd.launches) == \
        (before[0] + 1, before[1] + 2)
    assert lnk.fused_layernorm_bwd.vec_launches == vec_before + (2 if route == "vector" else 0)
    assert y.dtype == grads[0].dtype == dtype
    assert _rel(y, want) <= tol
    assert _rel(grads[0], want_grads[0]) <= max(tol, 1e-4)
    for got, ref, rerun in zip(grads[1:], want_grads[1:], again[1:]):
        assert got.dtype == torch.float32 and _rel(got, ref) <= 1e-4
        assert torch.equal(got, rerun)  # a fixed order of sums
    # through autograd: the Function's backward launches the kernel
    xs, ss, bs = (t.clone().requires_grad_() for t in (x, scale, bias))
    lnk.fused_layernorm(xs, ss, bs, 1e-6, act).backward(cot)
    assert torch.equal(xs.grad, grads[0]) and torch.equal(ss.grad, grads[1])


def test_stage_kernels_reject_bad_inputs(dev):
    with pytest.raises(ValueError, match="width"):  # past the kernels' 1024
        lnk.fused_layernorm(torch.zeros(4, 1100, device=dev), torch.ones(1100, device=dev),
                            torch.zeros(1100, device=dev))
    with pytest.raises(TypeError):
        lnk.fused_layernorm(torch.zeros(4, 8, device=dev, dtype=torch.float16),
                            torch.ones(8, device=dev), torch.zeros(8, device=dev))
    with pytest.raises(ValueError, match="codebook"):
        vqk.vq_assign_kernel(torch.zeros(4, 8, device=dev), torch.zeros(5, 9, device=dev))
    with pytest.raises(ValueError, match="multiple of 8"):  # no quiet fallback
        vqk.vq_assign_kernel(torch.zeros(4, 12, device=dev), torch.zeros(5, 12, device=dev))


def _small_server(dev, dtype, precision):
    """A seeded SchemaNet predictor (ViT 2 layers, d 64, 16 patches of 4^2;
    5 classes, 40 codes, GNN 32) served on the card, one class holding a
    code twice (whose table column then adds two weights atomically)."""
    from schemanet_torch.schema import build_predictor, init_parameters_
    from schemanet_torch.serve import ServePredictor

    model_cfg = {"name": "vit",
                 "transformer": dict(embed_dim=64, num_encoder_layers=2, num_heads=2,
                                     dim_feedforward=256, activation="gelu", norm_eps=1e-6),
                 "patch_embed": dict(img_size=16, patch_size=4, image_channels=3)}
    schema_cfg = {"gnn": {"embed_dim": 32, "num_layers": 2},
                  "ir_atlas": {"feat_h": 4, "feat_w": 4, "clamp_edge_attn": -1.0,
                               "prune_node_threshold": 0.001, "graph_precision": precision}}
    model = build_predictor(model_cfg, schema_cfg, 5, 40, 64, 1, dtype=dtype)
    init_parameters_(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.schema_net.class_ingredients[0, 7] = model.schema_net.class_ingredients[0, 3]
    return ServePredictor(model, microbatch=4, device=dev)


@pytest.mark.parametrize("dtype,precision", [(torch.float32, "highest"),
                                             (torch.bfloat16, "default")])
def test_explain_bitwise_run_to_run(dev, dtype, precision):
    """Every output of explain on the card has the same bits over two calls,
    a duplicated code's two weights added atomically included."""
    server = _small_server(dev, dtype, precision)
    images = torch.randn(6, 16, 16, 3, generator=torch.Generator().manual_seed(1)).to(dev)
    first, again = server.explain_tensor(images), server.explain_tensor(images)
    for key in first:
        assert torch.equal(first[key], again[key]), key


@pytest.mark.parametrize("dtype,precision", [(torch.float32, "highest"),
                                             (torch.bfloat16, "default")])
def test_explain_pred_equals_predict(dev, dtype, precision):
    server = _small_server(dev, dtype, precision)
    images = torch.randn(6, 16, 16, 3, generator=torch.Generator().manual_seed(2)).to(dev)
    assert torch.equal(server.explain_tensor(images)["pred"], server.predict_tensor(images))


def _ragged(g, shapes):
    images = [torch.randint(0, 256, (h, w, 3), generator=g, dtype=torch.uint8) for h, w in shapes]
    offsets = [0]
    for im in images[:-1]:
        offsets.append(offsets[-1] + im.numel())
    return torch.cat([im.reshape(-1) for im in images]), offsets


@pytest.mark.parametrize("out", [224, 37, 1, 129, 300])
def test_crop_resize_kernel(dev, out):
    """Bit for bit the plain version over a ragged batch: downscales and
    upscales, windows past both edges, flips, at outputs that leave a
    partial column tile (129, 300) or band of rows (37, 129, 300)."""
    g = torch.Generator().manual_seed(out)
    shapes = [(375, 500), (9, 17), (1, 1), (500, 333), (32, 32), (64, 640), (40, 50), (20, 30)]
    flat, offsets = _ragged(g, shapes)
    boxes = [(30, 40, 300, 400, 1), (0, 0, 9, 17, 0), (0, 0, 1, 1, 1), (100, 0, 292, 333, 0),
             (-4, 3, 32, 32, 1), (0, 600, 64, 40, 1), (-6, -8, 52, 66, 1), (3, 4, 10, 12, 0)]
    crop = torch.tensor([[o, h, w, *b] for o, (h, w), b in zip(offsets, shapes, boxes)])
    before = ipk.crop_resize.launches
    got = ipk.crop_resize(flat.to(dev), crop, out)
    again = ipk.crop_resize(flat.to(dev), crop, out)
    assert ipk.crop_resize.launches == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got.cpu(), ipk.crop_resize_reference(flat, crop, out))


@pytest.mark.parametrize("case", ["window16x", "chunked_rows", "no_table_x", "no_table_y"])
def test_crop_resize_kernel_wide_windows(dev, case):
    """The band kernel's other routes, bit for bit the plain version: a
    window 16x its output; source rows wider than its stage buffer (taken in
    chunks of columns); and taps too many for its coefficient tables, along
    x and along y (each coefficient computed where it is used)."""
    (h, w), box, out = {
        "window16x": ((600, 640), (4, 30, 592, 592, 1), 37),
        "chunked_rows": ((6, 4100), (1, 20, 5, 4000, 1), 8),
        "no_table_x": ((3, 41_700), (0, 50, 3, 41_600, 0), 1),
        "no_table_y": ((9_100, 2), (40, 0, 9_000, 2, 1), 3)}[case]
    flat, _ = _ragged(torch.Generator().manual_seed(7), [(h, w)])
    crop = torch.tensor([[0, h, w, *box]])
    got = ipk.crop_resize(flat.to(dev), crop, out)
    assert torch.equal(got, ipk.crop_resize(flat.to(dev), crop, out))
    assert torch.equal(got.cpu(), ipk.crop_resize_reference(flat, crop, out))


def test_ycc_to_rgb_kernel(dev):
    """Bit for bit the plain version, over two calls, at every chroma mode
    (1x1; 2h1v, 2h2v, 1h2v fancy; 4h1v, 4h2v and chroma 2 wide or less
    replicated; gray) on packed planes (rows mostly not 16-byte aligned): a
    pixel, 1-row images, odd sizes, rows 257 and 600 wide, a 4,000-wide
    image (two chunks), output offsets that are mostly not 16-byte aligned."""
    from schemanet_torch.kernel_times import YCC_MODES, YCC_SIZES, ycc_random_batch

    cases = [(h, w, hs, vs) for hs, vs in YCC_MODES for h, w in YCC_SIZES]
    planes, meta, total = ycc_random_batch(cases, 1)
    before = ipk.ycc_to_rgb.launches
    got = ipk.ycc_to_rgb(planes.to(dev), meta, total)
    again = ipk.ycc_to_rgb(planes.to(dev), meta, total)
    assert ipk.ycc_to_rgb.launches == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got.cpu(), ipk.ycc_to_rgb_reference(planes, meta, total))


def test_ycc_to_rgb_kernel_many_files(dev):
    """17,000 small files of every mode: a block finds its file in three
    rounds of the tiles' prefix search; bit for bit the plain version."""
    import numpy as np

    from schemanet_torch.kernel_times import YCC_MODES, ycc_random_batch

    rng = np.random.default_rng(4)
    cases = [(int(rng.integers(1, 4)), int(rng.integers(1, 20)), *YCC_MODES[i % 7])
             for i in range(17_000)]
    planes, meta, total = ycc_random_batch(cases, 2)
    got = ipk.ycc_to_rgb(planes.to(dev), meta, total)
    assert torch.equal(got.cpu(), ipk.ycc_to_rgb_reference(planes, meta, total))


def test_ycc_to_rgb_kernel_ring_grows_behind_a_queued_kernel(dev, monkeypatch):
    """A pinned slot outgrown while its last upload still waits behind a long
    kernel: 8 files, then 120 in the same slot (a ring of one; its buffer
    replaced), then pinned allocations written over; both outputs bit for
    bit their plain versions."""
    from schemanet_torch.kernel_times import YCC_MODES, YCC_SIZES, ycc_random_batch

    monkeypatch.setattr(ipk, "_ring", ipk._PinnedRing(slots=1))
    cases = [(h, w, hs, vs) for hs, vs in YCC_MODES for h, w in YCC_SIZES]
    small = ycc_random_batch(cases[:8], 5)
    large = ycc_random_batch((cases * 2)[:120], 6)
    planes_s, planes_l = small[0].to(dev), large[0].to(dev)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # ~0.1 s of one block spinning
    got_s = ipk.ycc_to_rgb(planes_s, small[1], small[2])
    got_l = ipk.ycc_to_rgb(planes_l, large[1], large[2])
    assert ipk._ring._bufs[0].numel() >= 120 * (ipk.YCC_REC + 1) * 8 > 2 * 4096
    for _ in range(4):
        torch.empty(1 << 16, dtype=torch.uint8, pin_memory=True).fill_(255)
    assert torch.equal(got_s.cpu(), ipk.ycc_to_rgb_reference(*small))
    assert torch.equal(got_l.cpu(), ipk.ycc_to_rgb_reference(*large))


def test_ycc_records_equal_the_tiling_model(dev):
    """The kernel library's records and tile count (``ycc_records``, the
    host half the kernel runs) equal the tiling model that the CPU tests
    hold (``tests/_torch_ycc_tiling.py``), word for word, over 3,000 files:
    every mode at ragged sizes from 1 x 1 to 5,000 wide and 9,000 high."""
    import numpy as np

    from schemanet_torch.kernel_times import YCC_MODES, YCC_SIZES
    from tests import _torch_ycc_tiling as ycc_tiles

    rng = np.random.default_rng(7)
    cases = [(h, w, hs, vs) for hs, vs in YCC_MODES for h, w in YCC_SIZES]
    cases += [(1, 5000, 2, 2), (9000, 3, 1, 2), (2, 2049, 2, 1), (129, 257, 0, 0)]
    cases += [(int(rng.integers(1, 300)), int(rng.integers(1, 5001)), *YCC_MODES[i % 7])
              for i in range(3000 - len(cases))]
    table, n_planes, total = ycc_tiles.table_of(cases)
    words, tiles = ipk.ycc_records(table, n_planes, total)
    np.testing.assert_array_equal(words, ycc_tiles.records(table))
    assert tiles == ycc_tiles.tile_counts(table[:, 3], table[:, 4]).sum()


@pytest.mark.parametrize("col,value", [(3, 0), (0, 90), (5, 1), (9, 1)])
def test_ycc_to_rgb_kernel_rejects_bad_tables(dev, col, value):
    """The wrapper refuses on the card what the plain version refuses, with
    its message, and launches nothing."""
    good = torch.tensor([[0, 16, 20, 4, 4, 2, 2, 2, 2, 0]])
    planes = torch.zeros(100, dtype=torch.uint8)
    assert torch.equal(ipk.ycc_to_rgb(planes.to(dev), good, 48).cpu(),
                       ipk.ycc_to_rgb_reference(planes, good, 48))
    bad = good.clone()
    bad[0, col] = value
    with pytest.raises(ValueError) as plain:
        ipk.ycc_to_rgb_reference(planes, bad, 48)
    before = ipk.ycc_to_rgb.launches
    with pytest.raises(ValueError, match=str(plain.value)):
        ipk.ycc_to_rgb(planes.to(dev), bad, 48)
    assert ipk.ycc_to_rgb.launches == before


def test_device_decode_near_libjpeg(dev):
    import os

    import numpy as np

    from schemanet_torch.data import jpeg

    if jpeg.decode_route() != jpeg.NVJPEG:
        pytest.skip("this machine decodes on the host (libjpeg)")
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "jpeg")
    pixels = np.load(os.path.join(root, "pixels.npz"))
    blobs = [open(os.path.join(root, f"{name}.JPEG"), "rb").read() for name in pixels.files]
    out, offsets = jpeg.decode_to_device(blobs, dev)
    for name, off in zip(pixels.files, offsets):
        want = pixels[name].astype(np.int32)
        got = out[off:off + want.size].cpu().numpy().reshape(want.shape).astype(np.int32)
        assert np.abs(got - want).max() <= 3 and np.abs(got - want).mean() < 0.2, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim", [192, 384])
def test_dropout_offsets_give_the_global_masks(dev, dtype, dim):
    """A data-parallel rank's launch over items 3.. of a batch of 7: the
    attention kernels (stream offset item0 x heads) and the FFN kernels (row
    offset) give, bit for bit, the rows of the launch over the whole batch,
    forward and backward; the plain versions with the same offsets agree
    within the tolerances."""
    g = torch.Generator().manual_seed(18)
    heads = dim // 64
    qkv = _rnd(g, dev, 7, 65, 3 * dim).to(dtype)
    go = _rnd(g, dev, 7, 65, dim).to(dtype)
    full = ak.fused_mhsa(qkv, heads, 0.1, 99)
    part = ak.fused_mhsa(qkv[3:].contiguous(), heads, 0.1, 99, item0=3)
    assert torch.equal(part, full[3:])
    assert torch.equal(ak.fused_mhsa_bwd(qkv[3:].contiguous(), go[3:].contiguous(), heads, 0.1,
                                         99, item0=3),
                       ak.fused_mhsa_bwd(qkv, go, heads, 0.1, 99)[3:])
    tol = dict(TOLS)[dtype]
    plain = ak.fused_mhsa_reference(qkv[3:], heads, 0.1, 99, item0=3)
    assert (part.float() - plain.float()).abs().max() <= tol * plain.float().abs().max()
    x = _rnd(g, dev, 7, 65, dim).to(dtype)
    w1, b1 = _rnd(g, dev, 4 * dim, dim, scale=dim**-0.5).to(dtype), _rnd(g, dev, 4 * dim).to(dtype)
    w2 = _rnd(g, dev, dim, 4 * dim, scale=(4 * dim)**-0.5).to(dtype)
    b2 = _rnd(g, dev, dim).to(dtype)
    full = mk.fused_mlp(x, w1, b1, w2, b2, "gelu", 0.1, 7)
    part = mk.fused_mlp(x[3:].contiguous(), w1, b1, w2, b2, "gelu", 0.1, 7, row0=3 * 65)
    assert torch.equal(part, full[3:])
    gx = _rnd(g, dev, 7, 65, dim).to(dtype)
    d_full = mk.fused_mlp_bwd(x, w1, b1, w2, gx, "gelu", 0.1, 7)
    d_part = mk.fused_mlp_bwd(x[3:].contiguous(), w1, b1, w2, gx[3:].contiguous(), "gelu", 0.1,
                              7, row0=3 * 65)
    assert torch.equal(d_part[0], d_full[0][3:])
    plain = mk.fused_mlp_reference(x[3:], w1, b1, w2, b2, "gelu", 0.1, 7, row0=3 * 65)
    assert (part.float() - plain.float()).abs().max() <= tol * plain.float().abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,k", [(12_608, 384), (1000, 3072), (77, 1152), (5, 8), (33, 1536)])
def test_quantize_rows_kernel(dev, dtype, rows, k):
    """Codes and scales bit for bit the plain version's, at the activation
    and weight widths and at edges of the pieces a lane holds; a zero row
    takes the 1e-12 floor, and a row of absmax 127 (scale exactly 1) rounds
    its halves to even."""
    g = torch.Generator().manual_seed(43)
    x = _rnd(g, dev, rows, k) * torch.rand(rows, 1, generator=g).to(dev) * 30
    x[0] = 0
    if rows > 1:
        x[1] = torch.arange(k, device=dev) % 9 - 4.5  # halves to even after scaling by 1
        x[1, 0] = 127
    x = x.to(dtype)
    q, s = qk.quantize_rows(x)
    want_q, want_s = qk.quantize_rows_reference(x)
    assert q.dtype == torch.int8 and s.shape == (rows, 1)
    assert torch.equal(q, want_q) and torch.equal(s, want_s)
    assert qk.quantize_rows.shape_launches.get((rows, k), 0) > 0


# the 12 projections of DeiT-Tiny, -Small and -Base (n, k) at a single row,
# one sequence and a serving microbatch, then ragged shapes: an odd n, k 32
# and k a multiple of 32 but not of the kernel's 128-byte stage
_PATH_GEMMS = [(rows, n, k) for rows in (1, 197, 12_608) for d in (192, 384, 768)
               for n, k in ((3 * d, d), (d, d), (4 * d, d), (d, 4 * d))]
_EDGE_GEMMS = [(1000, 384, 3072), (77, 200, 96), (5, 7, 32), (129, 130, 64), (300, 33, 32),
               (1, 1, 32), (131, 193, 160)]


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("rows,n,k", _PATH_GEMMS + _EDGE_GEMMS)
def test_int8_gemm_kernel(dev, out_dtype, bias, rows, n, k):
    """Bit for bit the plain version (exact sums in float64, the fp32
    epilogue in the same order) at the paths' shapes, on ragged tiles, an
    odd n, k 32 and k a multiple of 32 but not of the kernel's 128-byte
    stage; |sums| past 2^24 at k 3072."""
    g = torch.Generator().manual_seed(44)
    a = torch.randint(-127, 128, (rows, k), generator=g, dtype=torch.int8).to(dev)
    w = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8).to(dev)
    a_s, w_s = torch.rand(rows, generator=g).to(dev) / 127, torch.rand(n, generator=g).to(dev) / 127
    b = _rnd(g, dev, n) if bias else None
    y = qk.int8_gemm(a, w, a_s, w_s, b, out_dtype)
    want = qk.int8_gemm_reference(a, w, a_s, w_s, b, out_dtype)
    assert y.dtype == out_dtype and y.shape == (rows, n)
    assert torch.equal(y, want)


def test_int8_dense_on_the_kernels(dev):
    """``ops.quant.int8_dense`` launches the two kernels (x and the weight
    quantised, one product) and gives the plain versions' bits."""
    from schemanet_torch.ops import quant

    g = torch.Generator().manual_seed(45)
    x = _rnd(g, dev, 3, 197, 384).to(torch.bfloat16)
    w, b = _rnd(g, dev, 1536, 384, scale=384**-0.5), _rnd(g, dev, 1536)
    before = (qk.quantize_rows.launches, qk.int8_gemm.launches)
    y = quant.int8_dense(x, w, b)
    assert (qk.quantize_rows.launches - before[0], qk.int8_gemm.launches - before[1]) == (2, 1)
    xq, xs = qk.quantize_rows_reference(x)
    wq, ws = qk.quantize_rows_reference(w)
    want = qk.int8_gemm_reference(xq.reshape(-1, 384), wq, xs, ws, b, torch.bfloat16)
    assert y.shape == (3, 197, 1536) and torch.equal(y.reshape(-1, 1536), want)


def test_int8_route_rejects_bad_inputs(dev):
    a = torch.zeros(4, 48, dtype=torch.int8, device=dev)
    w = torch.zeros(8, 48, dtype=torch.int8, device=dev)
    s4, s8 = torch.ones(4, device=dev), torch.ones(8, device=dev)
    with pytest.raises(ValueError, match="multiple of 32"):
        qk.int8_gemm(a, w, s4, s8, None, torch.float32)
    a, w = a[:, :32].contiguous(), w[:, :32].contiguous()
    with pytest.raises(TypeError):
        qk.int8_gemm(a.float(), w, s4, s8, None, torch.float32)
    with pytest.raises(TypeError):
        qk.int8_gemm(a, w, s4, s8, None, torch.float16)
    with pytest.raises(ValueError, match="contiguous"):
        qk.int8_gemm(torch.zeros(32, 4, dtype=torch.int8, device=dev).t(), w, s4, s8, None,
                     torch.float32)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        qk.int8_gemm(a, w.cpu(), s4, s8, None, torch.float32)
    with pytest.raises(ValueError, match="multiple of 8"):
        qk.quantize_rows(torch.zeros(4, 12, device=dev))
    with pytest.raises(ValueError, match="3072"):
        qk.quantize_rows(torch.zeros(4, 3080, device=dev))
    with pytest.raises(TypeError):
        qk.quantize_rows(torch.zeros(4, 16, device=dev, dtype=torch.float16))
