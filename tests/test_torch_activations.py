"""The FFN kernels' activations (``ffn_block``, ``fused_mlp``) and the
activation registry against the JAX package, on the CPU.

A ViT config that names no activation is a relu ViT in both packages
(``_transformer_kwargs`` reads ``activation`` with the default "relu"); the
JAX package trains it with its fused kernels, whose ``_kernel_activation``
takes any registry activation forward and gelu or relu backward. Here:

* a relu ViT's stage-0 step on the port's plain versions against the JAX
  step with its fused attention and FFN kernels in interpret mode: the loss
  rtol 1e-5, every gradient leaf within 1e-5 of its largest value (fp32
  sums in other orders through 2 layers);
* ``ffn_block_reference`` and ``fused_mlp_reference`` (the plain versions
  the CUDA kernels are held to) against the JAX kernels in interpret mode
  for every activation the kernels compute, fp32: the forward within 1e-5
  of the largest value; the ``fused_mlp`` backward with gelu and relu,
  dropout live, within 1e-4 (the weight gradients sum over the rows); any
  other activation raises ``NotImplementedError`` at the backward, in both;
* the registry (glu and hard_sigmoid included) elementwise within 1e-6,
  and ``ACT_CODES`` against the kernels' ``FfnAct`` enum.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schemanet_torch.models.layers import ACTIVATIONS, get_activation
from schemanet_torch.models.port import from_jax_params, to_jax_params
from schemanet_torch.models.vit import get_model as torch_get_model
from schemanet_torch.ops.kernels import encoder_block as eb
from schemanet_torch.ops.kernels import mlp as mk
from schemanet_torch.schema import get_loss_fn as torch_get_loss_fn
from schemanet_tpu.models.layers import ACTIVATIONS as JAX_ACTIVATIONS
from schemanet_tpu.models.vit import get_model as jax_get_model
from schemanet_tpu.ops.pallas.encoder_block import ffn_block as jax_ffn_block
from schemanet_tpu.ops.pallas.mlp import fused_mlp as jax_fused_mlp
from schemanet_tpu.schema.loss import get_loss_fn as jax_get_loss_fn

FORWARD = ("gelu", "relu", "swish", "sigmoid", "hard_sigmoid", "none")
NUM_CLASSES, IMG, BATCH = 10, 32, 4
SEED = 12345
LOSS_CFG = {"name": "ce_loss", "weight_dict": {"cls": 1.0}}


def _leaves(tree, prefix=()):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_leaves(value, prefix + (key,)))
        else:
            out["/".join(prefix + (key,))] = np.asarray(value)
    return out


def _relu_vit_cfg():
    """A ViT config without an ``activation`` key: relu by default."""
    return {
        "name": "vit",
        "transformer": dict(embed_dim=32, num_encoder_layers=2, num_heads=2, dim_feedforward=64,
                            final_norm=True, norm_eps=1e-6),
        "patch_embed": dict(img_size=IMG, patch_size=8, image_channels=3),
    }


@pytest.fixture(scope="module")
def fused_jax():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCHEMANET_ATTN_BACKEND", "interpret")
        mp.setenv("SCHEMANET_MLP_BACKEND", "interpret")
        mp.setenv("SCHEMANET_LN_BACKEND", "interpret")
        yield


def test_relu_vit_stage0_step_matches_jax(fused_jax):
    model_j = jax_get_model(_relu_vit_cfg(), NUM_CLASSES)
    assert model_j.activation == "relu"
    rng = np.random.default_rng(0)
    image = rng.normal(size=(BATCH, IMG, IMG, 3)).astype(np.float32)
    label = rng.integers(0, NUM_CLASSES, size=BATCH).astype(np.int32)
    params = jax.tree_util.tree_map(np.asarray, dict(model_j.init(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)))["params"]))
    jax_loss = jax_get_loss_fn(LOSS_CFG)

    def total(p):
        out = model_j.apply({"params": p}, image, deterministic=False,
                            rngs={"dropout": jax.random.PRNGKey(1)})
        return jax_loss(out, {"label": label})["cls"]

    want_loss, want_grads = jax.jit(jax.value_and_grad(total))(params)
    model = torch_get_model(_relu_vit_cfg(), NUM_CLASSES)
    assert model.transformer.layers[0].mlp.activation == "relu"
    model.load_state_dict(from_jax_params(params, {}, model))
    out = model(torch.from_numpy(image), deterministic=False)
    loss = torch_get_loss_fn(LOSS_CFG)(out, {"label": torch.from_numpy(label)})["cls"]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got = _leaves(to_jax_params({n: p.grad for n, p in model.named_parameters()}))
    want = _leaves(jax.device_get(want_grads))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0, atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)


def _ffn_inputs(seed=0, bs=2, n=9, dim=16, f=64):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.normal(size=(bs, n, dim)).astype(np.float32),
        g=(1.0 + 0.1 * rng.normal(size=(dim,))).astype(np.float32),
        be=(0.1 * rng.normal(size=(dim,))).astype(np.float32),
        w1=(rng.normal(size=(dim, f)) * dim**-0.5 * 1.2).astype(np.float32),  # JAX [in, out]
        b1=(rng.normal(size=(f,)) * 0.1).astype(np.float32),
        w2=(rng.normal(size=(f, dim)) * f**-0.5 * 1.6).astype(np.float32),
        b2=(rng.normal(size=(dim,)) * 0.1).astype(np.float32),
    )


def _t(a, transpose=False):
    return torch.from_numpy(np.ascontiguousarray(a.T if transpose else a))


def _close(got, want, frac, what):
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("activation", FORWARD)
def test_ffn_block_reference_matches_jax(activation):
    inp = _ffn_inputs()
    want = jax_ffn_block(*(jnp.asarray(inp[k]) for k in ("x", "g", "be", "w1", "b1", "w2", "b2")),
                         activation=activation, eps=1e-6, interpret=True)
    got = eb.ffn_block(_t(inp["x"]), _t(inp["g"]), _t(inp["be"]), _t(inp["w1"], True),
                       _t(inp["b1"]), _t(inp["w2"], True), _t(inp["b2"]), eps=1e-6,
                       activation=activation)
    _close(got.numpy(), np.asarray(want), 1e-5, activation)


def _jax_mlp(inp, activation, p, grads):
    x = jnp.asarray(inp["x"])
    prm = {k: jnp.asarray(inp[k]) for k in ("w1", "b1", "w2", "b2")}
    kw = dict(dropout_p=p, seed=SEED) if p else {}

    def run(x_, q):
        return jax_fused_mlp(x_, q["w1"], q["b1"], q["w2"], q["b2"], activation=activation,
                             interpret=True, **kw)

    if not grads:
        return {"out": np.asarray(run(x, prm))}
    gx, gp = jax.grad(lambda x_, q: jnp.sum(jnp.sin(run(x_, q))), argnums=(0, 1))(x, prm)
    return {"x": np.asarray(gx), "w1": np.asarray(gp["w1"]).T, "b1": np.asarray(gp["b1"]),
            "w2": np.asarray(gp["w2"]).T, "b2": np.asarray(gp["b2"])}


def _torch_mlp(inp, activation, p, grads):
    x = _t(inp["x"]).requires_grad_(grads)
    prm = {"w1": _t(inp["w1"], True), "b1": _t(inp["b1"]), "w2": _t(inp["w2"], True),
           "b2": _t(inp["b2"])}
    for t in prm.values():
        t.requires_grad_(grads)
    out = mk.fused_mlp(x, prm["w1"], prm["b1"], prm["w2"], prm["b2"], activation, p,
                       SEED if p else None)
    if not grads:
        return {"out": out.detach().numpy()}
    torch.sin(out).sum().backward()
    return {"x": x.grad.numpy(), **{k: t.grad.numpy() for k, t in prm.items()}}


@pytest.mark.parametrize("activation", FORWARD)
def test_fused_mlp_forward_matches_jax(activation):
    inp = _ffn_inputs(1)
    _close(_torch_mlp(inp, activation, 0.0, False)["out"],
           _jax_mlp(inp, activation, 0.0, False)["out"], 1e-5, activation)


@pytest.mark.parametrize("activation", ["gelu", "relu"])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_fused_mlp_backward_matches_jax(activation, p):
    inp = _ffn_inputs(2)
    want = _jax_mlp(inp, activation, p, True)
    got = _torch_mlp(inp, activation, p, True)
    for name, w in want.items():
        _close(got[name], w, 1e-4, f"{activation} {name}")


def test_backward_takes_gelu_and_relu_only():
    inp = _ffn_inputs(3)
    with pytest.raises(NotImplementedError):
        _jax_mlp(inp, "swish", 0.0, True)
    with pytest.raises(NotImplementedError):
        _torch_mlp(inp, "swish", 0.0, True)
    with pytest.raises(ValueError, match="glu"):
        _torch_mlp(inp, "glu", 0.0, False)  # glu halves its input: no FFN kernel takes it


def test_registry_matches_jax():
    assert sorted(ACTIVATIONS) == sorted(JAX_ACTIVATIONS)
    x = np.linspace(-8, 8, 4000, dtype=np.float32).reshape(1, -1)
    for name, fn in JAX_ACTIVATIONS.items():
        want = np.asarray(fn(jnp.asarray(x)))
        got = get_activation(name)(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=name)


def test_act_codes_are_the_kernels_enum():
    src = (pathlib.Path(eb.__file__).parents[2] / "csrc" / "ffn.cuh").read_text()
    enum = dict(re.findall(r"kAct(\w+) = (\d+)", src))
    camel = {"gelu": "Gelu", "relu": "Relu", "swish": "Swish", "sigmoid": "Sigmoid",
             "hard_sigmoid": "HardSigmoid", "none": "None"}
    assert {name: int(enum[camel[name]]) for name in eb.ACT_CODES} == eb.ACT_CODES
    assert sorted(eb.ACT_CODES) == sorted(FORWARD)


def _gate_inputs(dtype, rows, dim=192, seed=4):
    rng = np.random.default_rng(seed)
    f = 4 * dim

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(dtype)

    return t(rows, dim), t(f, dim, scale=dim**-0.5), t(f, scale=0.1), t(dim, f, scale=f**-0.5), \
        t(rows, dim)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_relu_gate_read_back_and_replayed(dtype):
    """``kernel_gate`` reads the gate back from the backward's dW2 (on the
    CPU the wrapper's plain version: the plain gate); the plain backward
    given its own gate gives its own bits, and given one element set apart
    moves dx's row by that element's dA W1 alone."""
    from tests._torch_relu_gates import kernel_gate, plain_gate

    x, w1, b1, w2, g = _gate_inputs(dtype, 450)
    gate = plain_gate(x, w1, b1)
    assert torch.equal(kernel_gate(x, w1, b1, w2), gate)
    free = mk.fused_mlp_bwd_reference(x, w1, b1, w2, g, "relu", 0.1, SEED)
    locked = mk.fused_mlp_bwd_reference(x, w1, b1, w2, g, "relu", 0.1, SEED, gate=gate)
    assert all(torch.equal(a, b) for a, b in zip(free, locked))
    i, j = 7, int(torch.nonzero(gate[7])[0])
    apart = gate.clone()
    apart[i, j] = False
    moved = mk.fused_mlp_bwd_reference(x, w1, b1, w2, g.float().to(dtype), "relu", gate=apart)
    kept = mk.fused_mlp_bwd_reference(x, w1, b1, w2, g, "relu", gate=gate)
    da = (g[i].float() @ w2.float())[j]
    want = kept[0][i].float() - da.to(dtype).float() * w1[j].float()
    np.testing.assert_allclose(moved[0][i].float().numpy(), want.numpy(),
                               atol=(1e-5 if dtype == torch.float32 else 3e-2)
                               * float(kept[0].float().abs().max()))
    others = torch.arange(x.shape[0]) != i
    assert torch.equal(moved[0][others], kept[0][others])
    with pytest.raises(ValueError, match="relu"):
        mk.fused_mlp_bwd_reference(x, w1, b1, w2, g, "gelu", gate=gate)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gate_candidates_hold_other_summation_orders(dtype):
    """Every gate that other fp32 summation orders of x W1^T set apart from
    the plain version's is a candidate of ``gate_candidates``, a small share
    of the elements; a gate on h rounded otherwise than the TPU kernel
    rounds it (bf16: b1 added to the fp32 sum before the one rounding) sets
    elements apart that are not candidates, so the card's check would catch
    such a kernel."""
    from tests._torch_relu_gates import gate_candidates, gate_flips

    x, w1, b1, _, _ = _gate_inputs(dtype, 2000)
    dim, xf, wf = x.shape[-1], x.float(), w1.float()
    halves = xf[:, :dim // 2] @ wf[:, :dim // 2].t() + xf[:, dim // 2:] @ wf[:, dim // 2:].t()
    serial = torch.zeros(x.shape[0], w1.shape[0])
    for k in reversed(range(0, dim, 16)):
        serial = serial + xf[:, k:k + 16] @ wf[:, k:k + 16].t()
    assert gate_candidates(x, w1, b1).float().mean() < 1e-3
    for acc in (halves, serial):
        flips = gate_flips((acc.to(dtype) + b1) > 0, x, w1, b1)
        assert flips["flips_outside_candidates"] == 0, flips
    if dtype == torch.bfloat16:
        wrong = gate_flips((halves + b1.float()).to(dtype) > 0, x, w1, b1)
        assert wrong["flips_outside_candidates"] > 0, wrong
