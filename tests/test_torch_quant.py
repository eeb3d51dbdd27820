"""The port's W8A8 route of the frozen backbone against the JAX package's, on
the CPU: ``ops/quant.py`` op by op, the encoder under ``quant`` (JAX on its
per-op path, as ``tests/test_quant.py`` runs it), the predictor built with
``schema_net.quant_backbone``, ``ServePredictor(quant_int8=True)`` and
stage 1's ``collect_mid_features(quant=True)``, with the same numpy inputs
and the same weights (``models/port.py`` ``from_jax_params``). On the CPU
the kernels' plain versions run; the kernels themselves are held to them
on the card (``tests/test_torch_kernels_cuda.py``).

Bounds:

* op by op, bit for bit: codes and scales come from the same IEEE
  divisions and the same rounding (half to even), the int32 sums are exact
  on both sides, and the fp32 rescale and bias run in the same order;
* whole layers: at most 1e-4 of the activations' int8 codes may differ, each
  by 1 (a code flips where ``x / scale`` lies at .5 within the two
  frameworks' fp32 rounding of LayerNorm and attention), features within
  2e-3 x max (one flipped code moves an output by at most ~1/127 of its
  row's absmax times |w|), the classifiers' argmax equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schemanet_torch.models import transformer as tt
from schemanet_torch.models.port import from_jax_params
from schemanet_torch.models.vit import get_model as torch_get_model
from schemanet_torch.ops import quant as tq
from schemanet_torch.ops.kernels import attention as ak
from schemanet_torch.ops.kernels import encoder_block as eb
from schemanet_torch.ops.kernels import layernorm as lnk
from schemanet_torch.ops.kernels import quant as qk
from schemanet_torch.pipeline import collect_mid_features
from schemanet_torch.schema import build_predictor as torch_build_predictor
from schemanet_torch.serve import ServePredictor as TorchServePredictor
from schemanet_tpu.models.vit import get_model as jax_get_model
from schemanet_tpu.ops import geometry as jax_geometry
from schemanet_tpu.ops import quant as jq
from schemanet_tpu.pipeline import extract_ingredients as jax_extract
from schemanet_tpu.schema import build_predictor as jax_build_predictor
from schemanet_tpu.serve import ServePredictor as JaxServePredictor

IMG, PATCH, DIM, HEADS, LAYERS, CLASSES = 32, 8, 64, 4, 3, 10
MODEL_CFG = {
    "name": "deit",
    "transformer": dict(embed_dim=DIM, num_encoder_layers=LAYERS, num_heads=HEADS,
                        dim_feedforward=4 * DIM, dropout=None, activation="gelu",
                        final_norm=True, norm_eps=1e-6),
    "patch_embed": dict(img_size=IMG, patch_size=PATCH, image_channels=3),
    "pos_encoding": dict(name="learnable"),
}
SCHEMA_CFG = {
    "quant_backbone": True,
    "gnn": {"embed_dim": 16, "num_layers": 2},
    "ir_atlas": dict(feat_h=4, feat_w=4, clamp_vertex_attn=-1.0, clamp_edge_attn=-1.0,
                     prune_node_threshold=0.001, graph_precision="highest"),
}
K, M, ENCODE_LAYER = 5, 16, 1
CODE_TOL, FEAT_TOL = 1e-4, 2e-3


def _images(n, seed):
    return np.random.default_rng(seed).normal(size=(n, IMG, IMG, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def vits():
    """(JAX model, its params, the port's model with the same weights)."""
    model = jax_get_model(MODEL_CFG, CLASSES)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)))
    params = jax.tree_util.tree_map(np.asarray, dict(variables["params"]))
    port = torch_get_model(MODEL_CFG, CLASSES)
    port.load_state_dict(from_jax_params(params, {}, port))
    return model, params, port.requires_grad_(False)


class _Codes:
    """Records the activations' int8 codes of a run, in call order: the
    ``quantize_rows`` that ``int8_dot`` calls (weights go through
    ``quantize_weight`` and are not recorded)."""

    def __init__(self, monkeypatch, module, name="quantize_rows"):
        self.codes = []
        inner = getattr(module, name)

        def record(x):
            q, s = inner(x)
            self.codes.append(np.asarray(q).astype(np.int32).reshape(-1, q.shape[-1]))
            return q, s

        monkeypatch.setattr(module, name, record)


def _code_report(got, want):
    assert len(got) == len(want) and got
    diff = np.concatenate([np.abs(g - w).ravel() for g, w in zip(got, want)])
    return float((diff > 0).mean()), int(diff.max())


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [8, 192, 384, 768, 1536, 3072])
def test_quantize_rows_and_weight_match_jax(k, dtype):
    """Codes and scales bit for bit, from fp32 and from bf16, per row and per
    output channel ([out, in] here, [in, out] in JAX); a zero row takes the
    1e-12 floor and a row of absmax 127 (scale 1) rounds its halves to even."""
    rng = np.random.default_rng(k)
    x = (rng.normal(size=(67, k)) * rng.uniform(0.01, 30, size=(67, 1))).astype(np.float32)
    x[0] = 0
    x[1] = np.arange(k) % 9 - 4.5
    x[1, 0] = 127
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    q, s = tq.quantize_rows(tx)
    want_q, want_s = jq.quantize_rows(jx)
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(want_s))
    assert q.dtype == torch.int8 and s.shape == (67, 1)
    assert q[1, 1:8].tolist() == [-4, -2, -2, 0, 0, 2, 2]  # -3.5 ... 2.5 to even
    w_q, w_s = tq.quantize_weight(torch.from_numpy(x))
    want_wq, want_ws = jq.quantize_weight(jnp.asarray(x.T))
    np.testing.assert_array_equal(w_q.numpy(), np.asarray(want_wq).T)
    np.testing.assert_array_equal(w_s.numpy(), np.asarray(want_ws))


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_dot_and_dense_match_jax_at_k_3072(bias, dtype):
    """Bit for bit at k 3072, where the int32 sums pass 2^24: an fp32
    product would round them (shown here), the plain int32 product does not."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 21, 3072)).astype(np.float32)
    x[0, 0] = 1.0  # a row of equal values: every code 127
    w = rng.normal(size=(48, 3072)).astype(np.float32)
    w[0] = 1.0
    w[0, 0] = 0.5  # code 64: row 0's sum 127 (127 x 3071 + 64) is odd, past 2^24
    b = rng.normal(size=(48,)).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tb = torch.from_numpy(b) if bias else None
    params = {"kernel": jnp.asarray(w.T), **({"bias": jnp.asarray(b)} if bias else {})}
    got = tq.int8_dense(tx, torch.from_numpy(w), tb)
    want = jq.int8_dense(jx, params)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    w_q, w_s = tq.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(tq.int8_dot(tx, w_q, w_s, tb).float().numpy(),
                                  got.float().numpy())
    x_q, _ = tq.quantize_rows(tx)
    exact = x_q.reshape(-1, 3072).long() @ w_q.long().t()
    assert exact.abs().max() > 2**24
    as_fp32 = (x_q.reshape(-1, 3072).float() @ w_q.float().t()).long()
    assert not torch.equal(as_fp32, exact)
    assert torch.equal(torch.matmul(x_q.reshape(-1, 3072).int(), w_q.int().t()).long(), exact)


def _jax_encode(model, params, img, end, quant, capture=()):
    return model.apply({"params": params}, jnp.asarray(img), end, method="encode_until",
                       quant=quant, capture=capture)


def test_layers_under_quant_match_jax(vits, monkeypatch):
    """Each layer's attention half (resid1), FFN half (resid2) and output of
    the int8 route, and the activations' codes of all 12 projections, against
    the JAX package's int8 route, within the whole-layer bounds."""
    model, params, port = vits
    img = _images(4, 1)
    capture = tuple(f"layers_{i}.{k}" for i in range(LAYERS) for k in ("resid1", "resid2", "out"))
    jax_codes = _Codes(monkeypatch, jq)
    want_seq, want = _jax_encode(model, params, img, LAYERS, True, capture)
    port_codes = _Codes(monkeypatch, tq)
    with torch.no_grad():
        got_seq, got = port.encode_until(torch.from_numpy(img), LAYERS, capture, quant=True)
    share, worst = _code_report(port_codes.codes, jax_codes.codes)
    assert len(port_codes.codes) == 4 * LAYERS
    assert share <= CODE_TOL and worst <= 1, (share, worst)
    for name in capture:
        assert _rel(got[name].numpy(), want[name]) <= FEAT_TOL, name
    assert _rel(got_seq.numpy(), want_seq) <= FEAT_TOL
    assert not np.allclose(got_seq.numpy(), _jax_encode(model, params, img, LAYERS, False)[0],
                           rtol=0, atol=1e-6)  # the int8 route is not the fp32 one


def test_mlp_and_attention_quant_match_jax(vits):
    """The port's ``MLP.quant`` and ``MultiHeadSelfAttention.quant`` (with and
    without the attention maps) on the same input as the JAX modules' quant
    calls, layer 0's weights."""
    from schemanet_tpu.models.attention import MultiHeadSelfAttention as JaxMhsa
    from schemanet_tpu.models.layers import MLP as JaxMLP

    _, params, port = vits
    p0 = params["transformer"]["layers_0"]
    x = np.random.default_rng(5).normal(size=(3, 17, DIM)).astype(np.float32)
    layer = port.transformer.layers[0]
    with torch.no_grad():
        got_mlp = layer.mlp.quant(torch.from_numpy(x)).numpy()
        got_att = layer.attention.quant(torch.from_numpy(x))
        got_maps = layer.attention.quant(torch.from_numpy(x), maps=True)
    want_mlp = JaxMLP(DIM, 4 * DIM, None, "gelu").apply({"params": p0["mlp"]}, jnp.asarray(x),
                                                         quant=True)
    want_att = JaxMhsa(HEADS, DIM).apply({"params": p0["attention"]}, jnp.asarray(x), quant=True)
    assert _rel(got_mlp, want_mlp) <= FEAT_TOL
    assert got_att[1] is None and got_att[2] is None
    for out in (got_att[0], got_maps[0]):
        assert _rel(out.numpy(), want_att[0]) <= FEAT_TOL
    assert _rel(got_maps[1].numpy(), want_att[1]) <= FEAT_TOL
    assert _rel(got_maps[2].numpy(), want_att[2]) <= FEAT_TOL


def test_encode_until_hmean_and_resume_match_jax(vits):
    """``encode_until`` with the head-mean probe of the encode layer (the
    per-op attention between its int8 projections), then
    ``resume_from_layer`` to the logits: the probe and the features within
    the bounds, the argmax equal."""
    model, params, port = vits
    img = _images(6, 2)
    probe = (f"layers_{ENCODE_LAYER}.attn_hmean",)
    want_seq, want = _jax_encode(model, params, img, ENCODE_LAYER + 1, True, probe)
    want_logits = model.apply({"params": params}, want_seq, ENCODE_LAYER + 1,
                              method="resume_from_layer", quant=True)["pred"]
    with torch.no_grad():
        seq, got = port.encode_until(torch.from_numpy(img), ENCODE_LAYER + 1, probe, quant=True)
        logits = port.resume_from_layer(seq, ENCODE_LAYER + 1, quant=True)["pred"]
    assert _rel(seq.numpy(), want_seq) <= FEAT_TOL
    assert _rel(got[probe[0]].numpy(), want[probe[0]]) <= FEAT_TOL
    assert _rel(logits.numpy(), want_logits) <= FEAT_TOL
    np.testing.assert_array_equal(logits.numpy().argmax(-1), np.asarray(want_logits).argmax(-1))


class _Calls:
    """Counts the calls of the route's wrappers on the CPU (the plain
    versions count no launches)."""

    def __init__(self, monkeypatch):
        self.n = {}
        for name, module, attr in (("quantize_rows", qk, "quantize_rows"),
                                   ("int8_gemm", qk, "int8_gemm"),
                                   ("fused_layernorm", lnk, "fused_layernorm"),
                                   ("fused_mhsa", ak, "fused_mhsa"),
                                   ("attn_block", eb, "attn_block"),
                                   ("ffn_block", eb, "ffn_block")):
            monkeypatch.setattr(module, attr, self._counted(name, getattr(module, attr)))

    def _counted(self, name, fn):
        def call(*args, **kwargs):
            self.n[name] = self.n.get(name, 0) + 1
            return fn(*args, **kwargs)
        return call


def test_quant_route_takes_the_int8_kernels_and_no_block_kernel(vits, monkeypatch):
    """Per layer: 4 int8 products, 8 quantisations (x and the weight of
    each), 2 LayerNorms and ``fused_mhsa``, except on the layer whose
    head-mean is captured (the per-op attention); no ``attn_block`` or
    ``ffn_block``. The final norm only where the stack runs to its end."""
    _, _, port = vits
    calls = _Calls(monkeypatch)
    with torch.no_grad():
        port.encode_until(torch.from_numpy(_images(2, 3)), ENCODE_LAYER + 1,
                          (f"layers_{ENCODE_LAYER}.attn_hmean",), quant=True)
    layers = ENCODE_LAYER + 1
    assert calls.n == {"quantize_rows": 8 * layers, "int8_gemm": 4 * layers,
                       "fused_layernorm": 2 * layers, "fused_mhsa": layers - 1}
    calls.n.clear()
    with torch.no_grad():
        port.resume_from_layer(torch.zeros(2, 18, DIM), ENCODE_LAYER + 1, quant=True)
    rest = LAYERS - layers
    assert calls.n == {"quantize_rows": 8 * rest, "int8_gemm": 4 * rest,
                       "fused_layernorm": 2 * rest + 1, "fused_mhsa": rest}
    with pytest.raises(ValueError, match="int8"):
        port.transformer.layers[0](torch.zeros(1, 3, DIM), deterministic=False, quant=True)


@pytest.fixture(scope="module")
def predictors():
    """The JAX predictor built with ``quant_backbone: true``, its variables,
    and the port's predictor from the same config and weights."""
    predictor = jax_build_predictor(MODEL_CFG, SCHEMA_CFG, K, M, DIM, ENCODE_LAYER)
    assert predictor.cfg.quant_backbone
    jax_geometry.pairwise_point_sim(4, 4, 1.0, 2.0)
    variables = jax.jit(lambda key, x: predictor.init(key, x, method="init_full"))(
        jax.random.PRNGKey(1), jnp.zeros((1, IMG, IMG, 3)))
    params = jax.tree_util.tree_map(np.asarray, dict(variables["params"]))
    buffers = jax.tree_util.tree_map(np.asarray, dict(variables["buffers"]))
    port = torch_build_predictor(MODEL_CFG, SCHEMA_CFG, K, M, DIM, ENCODE_LAYER)
    port.load_state_dict(from_jax_params(params, buffers, port), strict=True)
    return predictor, params, buffers, port


def test_predictor_with_quant_backbone_matches_jax(predictors):
    """``schema_net.quant_backbone: true`` runs the int8 frozen forward in the
    port as in JAX: VQ ids equal, the encode layer's features and logits
    within the bounds, argmax equal; and the codebook-agreement
    classifier (``classify_discretized``) takes the int8 route too."""
    predictor, params, buffers, port = predictors
    assert port.cfg.quant_backbone and port.ingredient_backbone.quant_backbone
    img = _images(6, 4)
    variables = {"params": params, "buffers": buffers}
    want = predictor.apply(variables, jnp.asarray(img), True)
    with torch.no_grad():
        got = port(torch.from_numpy(img), requires_graph=True)
        mid = port.ingredient_backbone(torch.from_numpy(img))["mid_feat"]
        mid_fp32 = port.ingredient_backbone(torch.from_numpy(img), quant=False)["mid_feat"]
    want_mid = predictor.apply(variables, jnp.asarray(img),
                               method=lambda m, x: m.ingredient_backbone(x)["mid_feat"])
    np.testing.assert_array_equal(got["ingredients"].numpy(), np.asarray(want["ingredients"]))
    assert _rel(mid.numpy(), want_mid) <= FEAT_TOL
    assert not torch.equal(mid, mid_fp32)
    assert _rel(got["pred"].numpy(), want["pred"]) <= FEAT_TOL
    np.testing.assert_array_equal(got["pred"].numpy().argmax(-1),
                                  np.asarray(want["pred"]).argmax(-1))
    for quantize in (True, False):
        want_c = predictor.apply(variables, jnp.asarray(img), quantize,
                                 method=lambda m, x, q: m.ingredient_backbone.classify_discretized(
                                     x, q))
        with torch.no_grad():
            got_c = port.classify_discretized(torch.from_numpy(img), quantize)
        assert _rel(got_c.numpy(), want_c) <= FEAT_TOL
        np.testing.assert_array_equal(got_c.numpy().argmax(-1), np.asarray(want_c).argmax(-1))


def test_serve_quant_int8_matches_jax_and_leaves_the_caller_as_it_was(predictors):
    """``ServePredictor(quant_int8=True)`` on a predictor built without
    ``quant_backbone``: the logits of JAX's ``ServePredictor(quant_int8=True)``
    within the bounds (argmax equal), different from the bf16/fp32 route's,
    and the caller's model, config and weights unchanged, so a server
    without the flag afterwards serves the unquantised logits bit for bit."""
    predictor, params, buffers, _ = predictors
    plain_cfg = dict(SCHEMA_CFG, quant_backbone=False)
    jax_plain = jax_build_predictor(MODEL_CFG, plain_cfg, K, M, DIM, ENCODE_LAYER)
    model = torch_build_predictor(MODEL_CFG, plain_cfg, K, M, DIM, ENCODE_LAYER)
    model.load_state_dict(from_jax_params(params, buffers, model), strict=True)
    img = _images(7, 5)
    want = JaxServePredictor(jax_plain, params, buffers, microbatch=4, quant_int8=True).predict(img)
    before = TorchServePredictor(model, microbatch=4, device="cpu").predict(img)
    cfg = model.cfg
    state = {k: v.clone() for k, v in model.state_dict().items()}
    server = TorchServePredictor(model, microbatch=4, device="cpu", quant_int8=True)
    got = server.predict(img)
    assert _rel(got, want) <= FEAT_TOL
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert not np.array_equal(got, before)
    np.testing.assert_array_equal(server.predict(img[:3]), got[:3])  # batch invariant
    assert model.cfg is cfg and not model.cfg.quant_backbone
    assert not model.ingredient_backbone.quant_backbone
    assert all(torch.equal(v, state[k]) for k, v in model.state_dict().items())
    np.testing.assert_array_equal(TorchServePredictor(model, microbatch=4, device="cpu")
                                  .predict(img), before)
    # a config with quant_backbone serves int8 without the flag
    quant_model = torch_build_predictor(MODEL_CFG, SCHEMA_CFG, K, M, DIM, ENCODE_LAYER)
    quant_model.load_state_dict(model.state_dict())
    np.testing.assert_array_equal(
        TorchServePredictor(quant_model, microbatch=4, device="cpu").predict(img), got)
    assert dataclasses.replace(quant_model.cfg, quant_backbone=False) == model.cfg


def test_collect_mid_features_quant_matches_jax(vits, monkeypatch):
    """Stage 1's features under ``quant`` against the JAX stage's, and the
    codes against those of the JAX route run eagerly on the same batches;
    the fp32 features stay apart from them."""
    model, params, port = vits
    loader = [{"image": _images(5, 6), "label": np.zeros(5, np.int64)},
              {"image": _images(5, 7), "label": np.zeros(5, np.int64)}]
    want = jax_extract.collect_mid_features(model, params, loader, ENCODE_LAYER, 150, quant=True)
    jax_codes = _Codes(monkeypatch, jq)  # the JAX stage jits: its codes from an eager run
    for batch in loader:
        _jax_encode(model, params, batch["image"], ENCODE_LAYER + 1, True)
    port_codes = _Codes(monkeypatch, tq)
    got = collect_mid_features(port, loader, ENCODE_LAYER, 150, quant=True)
    assert got.shape == want.shape == (150, DIM)
    assert _rel(got.numpy(), want) <= FEAT_TOL
    share, worst = _code_report(port_codes.codes, jax_codes.codes)
    assert share <= CODE_TOL and worst <= 1, (share, worst)
    fp32 = collect_mid_features(port, loader, ENCODE_LAYER, 150)
    assert not torch.equal(got, fp32)


def test_extract_stage_quant(vits):
    """``extract_stage(quant=True)``: the codebook from the int8 route's
    features, of the config's shape, finite, other than the fp32 route's."""
    from schemanet_torch.pipeline import extract_stage

    cfg = {"model": MODEL_CFG, "dataset": {"name": "synthetic", "num_classes": CLASSES},
           "discretization": {"vocabulary": {"size": 8},
                              "encoder_layer": f"module.transformer.layers.{ENCODE_LAYER}"}}
    loader = [{"image": _images(16, 8), "label": np.zeros(16, np.int64)}]
    kw = dict(seed=0, device="cpu", max_features=256, lloyd_iters=2, lloyd_sample=256)
    quant = extract_stage(cfg, loader, quant=True, **kw)
    fp32 = extract_stage(cfg, loader, **kw)
    assert quant.codebook.shape == (8, DIM) and bool(torch.isfinite(quant.codebook).all())
    assert not torch.equal(quant.codebook, fp32.codebook)


@pytest.mark.parametrize("kind, per_op", [("attn", True), ("attn_raw", True),
                                           ("resid1", False), ("resid2", False)])
def test_only_the_maps_take_the_per_op_attention(vits, monkeypatch, kind, per_op):
    """Under quant a layer takes the per-op attention only where one of its
    maps is captured (as in the JAX package, where resid1 and resid2 leave
    the fused attention alone); every probe comes back."""
    _, _, port = vits
    calls = _Calls(monkeypatch)
    with torch.no_grad():
        _, got = port.encode_until(torch.from_numpy(_images(2, 9)), LAYERS, (f"layers_0.{kind}",),
                                   quant=True)
    assert set(got) == {f"layers_0.{kind}"}
    assert calls.n["fused_mhsa"] == LAYERS - per_op
    assert set(tt.MAP_PROBES) == {"attn", "attn_raw", "attn_hmean"}
