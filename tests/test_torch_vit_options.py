"""The ViT options the port takes beside the pre-norm learnable-position
default, against the JAX package on the CPU, fp32: the identity position
encoding, post-norm layers (``pre_norm: false``) and an additive attention
mask.

The JAX side runs its fused attention and FFN kernels in interpret mode
(where it takes them: whole-layer fusion declines for post-norm, both
attention kernels for a mask); the port runs the kernels' plain versions, on
the route its CUDA forward takes (``models/transformer.py``). Tolerances: outputs, losses and every gradient leaf
within 1e-5 of the largest value (fp32 sums in other orders through 2
layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schemanet_torch.models.layers import IdentityPosEncoding
from schemanet_torch.models.port import from_jax_params, to_jax_params
from schemanet_torch.models.transformer import Transformer
from schemanet_torch.models.vit import get_model as torch_get_model
from schemanet_torch.ops.kernels import layernorm as lnk
from schemanet_torch.ops.kernels import mlp as mk
from schemanet_torch.schema import get_loss_fn as torch_get_loss_fn
from schemanet_tpu.models.transformer import Transformer as JaxTransformer
from schemanet_tpu.models.vit import get_model as jax_get_model
from schemanet_tpu.schema.loss import get_loss_fn as jax_get_loss_fn

NUM_CLASSES, IMG, BATCH, N, DIM = 10, 16, 2, 9, 32
LOSS_CFG = {"name": "ce_loss", "weight_dict": {"cls": 1.0}}


def _leaves(tree, prefix=()):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_leaves(value, prefix + (key,)))
        else:
            out["/".join(prefix + (key,))] = np.asarray(value)
    return out


def _close(got, want, what, frac=1e-5):
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * np.abs(want).max(), err_msg=what)


def _close_trees(got, want, what):
    assert sorted(got) == sorted(want), what
    for name, w in want.items():
        _close(got[name], w, f"{what} {name}")


@pytest.fixture(scope="module", autouse=True)
def fused_jax():
    with pytest.MonkeyPatch.context() as mp:
        for kernel in ("ATTN", "MLP"):
            mp.setenv(f"SCHEMANET_{kernel}_BACKEND", "interpret")
        yield


def _vit_cfg(pre_norm, pos, activation="gelu"):
    return {
        "name": "vit",
        "transformer": dict(embed_dim=DIM, num_encoder_layers=2, num_heads=2, dim_feedforward=64,
                            final_norm=True, norm_eps=1e-6, pre_norm=pre_norm,
                            activation=activation),
        "patch_embed": dict(img_size=IMG, patch_size=8, image_channels=3),
        "pos_encoding": {"name": pos},
    }


VITS = {
    "post_norm_identity": (False, "identity", "gelu"),
    "post_norm_learnable_relu": (False, "learnable", "relu"),
    "pre_norm_identity": (True, "identity", "gelu"),
}


@pytest.mark.parametrize("which", sorted(VITS))
def test_vit_forwards_and_gradients_match_jax(which):
    cfg = _vit_cfg(*VITS[which])
    model_j = jax_get_model(cfg, NUM_CLASSES)
    params = jax.tree_util.tree_map(np.asarray, dict(model_j.init(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)))["params"]))
    model = torch_get_model(cfg, NUM_CLASSES)
    model.load_state_dict(from_jax_params(params, {}, model))
    if VITS[which][1] == "identity":
        assert isinstance(model.pos_embed, IdentityPosEncoding) and "pos_embed" not in params
    rng = np.random.default_rng(1)
    image = rng.normal(size=(BATCH, IMG, IMG, 3)).astype(np.float32)
    label = rng.integers(0, NUM_CLASSES, size=BATCH).astype(np.int32)
    jax_loss = jax_get_loss_fn(LOSS_CFG)

    def total(p):
        out = model_j.apply({"params": p}, image, deterministic=False)
        return jax_loss(out, {"label": label})["cls"]

    want_eval = np.asarray(model_j.apply({"params": params}, image)["pred"])
    want_loss, want_grads = jax.jit(jax.value_and_grad(total))(params)
    with torch.no_grad():
        _close(model(torch.from_numpy(image))["pred"].numpy(), want_eval, "eval")
    out = model(torch.from_numpy(image), deterministic=False)
    loss = torch_get_loss_fn(LOSS_CFG)(out, {"label": torch.from_numpy(label)})["cls"]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    _close_trees(_leaves(to_jax_params({n: p.grad for n, p in model.named_parameters()})),
                 _leaves(jax.device_get(want_grads)), which)


def _causal_mask():
    keep = np.tril(np.ones((N, N), bool))
    return np.where(keep, 0.0, -1e9).astype(np.float32)[None, None]  # [1, 1, n, n]


@pytest.fixture(scope="module", params=[True, False], ids=["pre_norm", "post_norm"])
def stacks(request):
    """A 2-layer stack of each norm order, the JAX variables and the port's."""
    kw = dict(num_encoder_layers=2, num_heads=2, embed_dim=DIM, dim_feedforward=64,
              activation="relu", final_norm=True, norm_eps=1e-6, pre_norm=request.param)
    jt = JaxTransformer(**kw)
    seq = np.random.default_rng(2).normal(size=(BATCH, N, DIM)).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, dict(jt.init(
        jax.random.PRNGKey(3), jnp.asarray(seq))["params"]))
    tt = Transformer(**kw)
    tt.load_state_dict(from_jax_params(params, {}, tt))
    return jt, params, tt, seq


def test_masked_stack_matches_jax(stacks):
    """Frozen and training forwards with a causal mask, the probes of the
    masked attention, and the gradients of the parameters and the input."""
    jt, params, tt, seq = stacks
    mask = _causal_mask()
    capture = ("layers_1.attn", "layers_0.attn_hmean", "layers_1.resid2")
    want, want_probes = jt.apply({"params": params}, jnp.asarray(seq), jnp.asarray(mask),
                                 capture=capture, method=JaxTransformer.run)
    got, probes = tt.run(torch.from_numpy(seq), capture=capture, attn_mask=torch.from_numpy(mask))
    _close(got.detach().numpy(), np.asarray(want), "frozen")
    assert sorted(probes) == sorted(want_probes)
    for name, w in want_probes.items():
        _close(probes[name].detach().numpy(), np.asarray(w), name)
    attn = probes["layers_1.attn"].detach().numpy()
    assert np.all(attn[..., np.triu_indices(N, 1)[0], np.triu_indices(N, 1)[1]] == 0)

    w = np.random.default_rng(4).normal(size=seq.shape).astype(np.float32)

    def total(p, x):
        y, _ = jt.apply({"params": p}, x, jnp.asarray(mask), deterministic=False,
                        method=JaxTransformer.run)
        return jnp.sum(y * w)

    want_gp, want_gx = jax.grad(total, argnums=(0, 1))(params, jnp.asarray(seq))
    x = torch.from_numpy(seq).requires_grad_()
    y, _ = tt.run(x, deterministic=False, attn_mask=torch.from_numpy(mask))
    (y * torch.from_numpy(w)).sum().backward()
    _close(x.grad.numpy(), np.asarray(want_gx), "d seq")
    _close_trees(_leaves(to_jax_params({n: p.grad for n, p in tt.named_parameters()})),
                 _leaves(jax.device_get(want_gp)), "masked")


def test_masked_kernel_route_matches_jax(stacks, monkeypatch):
    """The route a masked frozen layer takes on CUDA (``_kernel_forward``:
    the per-op attention with the mask, ``fused_layernorm`` for both norms,
    ``fused_mlp``), here on the wrappers' plain versions: the stack's output
    against JAX's masked run, each wrapper called as on the card."""
    jt, params, tt, seq = stacks
    mask = _causal_mask()
    want, _ = jt.apply({"params": params}, jnp.asarray(seq), jnp.asarray(mask),
                       method=JaxTransformer.run)
    calls = {"fused_layernorm": 0, "fused_mlp": 0}

    def counted(module, name):
        fn = getattr(module, name)

        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)

        monkeypatch.setattr(module, name, call)

    counted(lnk, "fused_layernorm")
    counted(mk, "fused_mlp")
    x, m = torch.from_numpy(seq), torch.from_numpy(mask)
    with torch.no_grad():
        if not tt.pre_norm:
            x = tt._final_norm(x)
        for layer in tt.layers:
            x = layer._kernel_forward(x, False, m)[0]
        if tt.pre_norm:
            x = tt._final_norm(x)
    _close(x.numpy(), np.asarray(want), "masked kernel route")
    assert calls == {"fused_layernorm": 2 * len(tt.layers) + 1, "fused_mlp": len(tt.layers)}


def test_post_norm_final_norm_comes_first(stacks):
    """A post-norm stack applies its final norm at its start, and only from
    layer 0: a run resumed from layer 1 does not apply it; a pre-norm stack
    applies it at the end."""
    jt, params, tt, seq = stacks
    for start in (0, 1):
        want, _ = jt.apply({"params": params}, jnp.asarray(seq), start_layer=start,
                           method=JaxTransformer.run)
        with torch.no_grad():
            got, _ = tt.run(torch.from_numpy(seq), start_layer=start)
        _close(got.numpy(), np.asarray(want), f"start {start}")
    with torch.no_grad():
        x = torch.from_numpy(seq)
        whole, _ = tt.run(x)
        split, _ = tt.run(tt.run(x, end_layer=1)[0], start_layer=1)
        torch.testing.assert_close(whole, split)
        normed = lnk.fused_layernorm(x, tt.norm.weight, tt.norm.bias, 1e-6)
        if tt.pre_norm:  # no layer left: the final norm alone
            torch.testing.assert_close(tt.run(x, start_layer=2)[0], normed)
        else:  # no layer run: the final norm alone, applied first
            torch.testing.assert_close(tt.run(x, end_layer=0)[0], normed)
