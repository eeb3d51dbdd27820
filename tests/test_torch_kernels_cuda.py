"""The hand-written CUDA kernels against their plain PyTorch versions on the
card, at small shapes whose edges are not multiples of the kernels' tiles.

Needs an NVIDIA GPU and nvcc: every test carries the ``cuda`` marker and skips
without a card. Imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

Tolerances, relative to max |plain|: fp32 1e-5 (summation order only), bf16
2e-2 (a few bf16 ulps where roundings meet in another order). The fused attention and FFN kernels
are held to the plain versions of their forward and their backward, with
dropout off and at p = 0.1 with the same seed.

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
too.
"""

import pytest
import torch

from schemanet_torch.ops.kernels import atlas_opt as ao
from schemanet_torch.ops.kernels import attention as ak
from schemanet_torch.ops.kernels import embed_bwd as ek
from schemanet_torch.ops.kernels import encoder_block as eb
from schemanet_torch.ops.kernels import graphconv as gc
from schemanet_torch.ops.kernels import layernorm as lnk
from schemanet_torch.ops.kernels import mlp as mk
from schemanet_torch.ops.kernels import vq as vqk

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
    with pytest.raises(ValueError, match="width"):
        lnk.fused_layernorm(torch.zeros(4, 800, device=dev), torch.ones(800, device=dev),
                            torch.zeros(800, device=dev))
    with pytest.raises(TypeError):
        lnk.fused_layernorm(torch.zeros(4, 8, device=dev, dtype=torch.float16),
                            torch.ones(8, device=dev), torch.zeros(8, device=dev))
    with pytest.raises(ValueError, match="codebook"):
        vqk.vq_assign_kernel(torch.zeros(4, 8, device=dev), torch.zeros(5, 9, device=dev))
    with pytest.raises(ValueError, match="multiple of 8"):  # no quiet fallback
        vqk.vq_assign_kernel(torch.zeros(4, 12, device=dev), torch.zeros(5, 12, device=dev))
