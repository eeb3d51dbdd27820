"""``schemanet_torch/models/layers_extra.py`` against
``schemanet_tpu/models/layers_extra.py``, module by module, on the CPU in
fp32, on the same seeded NHWC inputs and the JAX modules' variables (flax
``kernel`` HWIO -> ``weight`` OIHW, ``scale`` -> ``weight``,
``batch_stats`` -> the running buffers). Tolerance: 1e-5 of the largest
value (fp32 sums in other orders), the running statistics as well.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schemanet_torch.models import layers_extra as tx
from schemanet_torch.models.port import from_jax_params
from schemanet_tpu.models import layers_extra as jx

SHAPE = (2, 6, 5, 8)  # [bs, H, W, C]


def _x(seed=0, shape=SHAPE):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, what="", frac=1e-5):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * np.abs(want).max(), err_msg=what)


def _load(module, variables):
    """The JAX variables onto ``module``, with random non-trivial values (a
    JAX ChannelNorm holds its scale and bias in an inner ``LayerNorm_0``,
    the port's in the module itself)."""
    params = jax.tree_util.tree_map(np.asarray, dict(variables.get("params", {})))
    stats = jax.tree_util.tree_map(np.asarray, dict(variables.get("batch_stats", {})))
    rng = np.random.default_rng(9)
    params = jax.tree_util.tree_map(
        lambda a: (a + 0.1 * rng.normal(size=a.shape)).astype(np.float32), params)
    module.load_state_dict(from_jax_params(params.get("LayerNorm_0", params), stats, module))
    return {"params": params, **({"batch_stats": stats} if stats else {})}


@pytest.mark.parametrize("kind", ["conv_1x1", "conv_3x3"])
def test_conv_helpers_match_jax(kind):
    jm = getattr(jx, kind)(12)
    x = _x()
    variables = _load(tm := getattr(tx, kind)(SHAPE[-1], 12), jm.init(jax.random.PRNGKey(0), x))
    _close(tm(torch.from_numpy(x)), jm.apply(variables, x), kind)
    assert tx.conv_out_shape((6, 5), 3, 2, 1) == jx.conv_out_shape((6, 5), 3, 2, 1) == (3, 3)


@pytest.mark.parametrize("name", sorted(jx.NORM_REGISTRY))
def test_norm_registry_matches_jax(name):
    kwargs = {"use_running_average": False} if name == "batch_norm" else {}
    jm = jx.get_norm(name, **kwargs)
    x = _x(1) * 3 + 1
    tm = tx.get_norm(name, SHAPE[-1], **kwargs)
    if name == "none":
        _close(tm(torch.from_numpy(x)), jm(x), name)
        return
    variables = _load(tm, jm.init(jax.random.PRNGKey(0), x))
    if name == "batch_norm":
        want, mutated = jm.apply(variables, x, mutable=["batch_stats"])
        _close(tm(torch.from_numpy(x)), want, name)
        _close(tm.mean, mutated["batch_stats"]["mean"], "mean")  # momentum 0.99
        _close(tm.var, mutated["batch_stats"]["var"], "var")
        return
    _close(tm(torch.from_numpy(x)), jm.apply(variables, x), name)


def test_layer_norm_2d_reduces_over_hwc_with_a_channel_scale():
    """flax's ``feature_axes=-1``: the scale and bias are [C], not [H, W, C]."""
    tm = tx.LayerNorm2D(SHAPE[-1])
    assert tm.weight.shape == tm.bias.shape == (SHAPE[-1],)
    x = torch.from_numpy(_x(2))
    y = tm(x)
    torch.testing.assert_close(y.mean(dim=(1, 2, 3)), torch.zeros(SHAPE[0]), atol=1e-6,
                               rtol=0)


def _nan_input():
    x = _x(3) * 2 + 0.5
    x[0, 1, 2, :3] = np.nan
    x[1, 4, 0, 5] = np.inf
    return x


@pytest.mark.parametrize("train", [True, False])
def test_nan_batch_norm_matches_jax(train):
    jm = jx.NanBatchNorm()
    x = _nan_input()
    tm = tx.NanBatchNorm(SHAPE[-1])
    variables = _load(tm, jm.init(jax.random.PRNGKey(0), x))
    variables["batch_stats"] = {"mean": np.full(SHAPE[-1], 0.3, np.float32),
                                "var": np.full(SHAPE[-1], 1.7, np.float32)}
    with torch.no_grad():
        tm.mean.fill_(0.3)
        tm.var.fill_(1.7)
    want, mutated = jm.apply(variables, x, use_running_average=not train,
                             mutable=["batch_stats"])
    got = tm(torch.from_numpy(x), use_running_average=not train)
    finite = np.isfinite(np.asarray(want))
    assert np.array_equal(np.isfinite(got.detach().numpy()), finite)  # non-finite pass through
    _close(got.detach().numpy()[finite], np.asarray(want)[finite], "out")
    _close(tm.mean, mutated["batch_stats"]["mean"], "mean")
    _close(tm.var, mutated["batch_stats"]["var"], "var")
    if not train:
        assert torch.equal(tm.mean, torch.full((SHAPE[-1],), 0.3))


def test_mlp_2d_matches_jax():
    jm = jx.MLP2D(embed_dim=SHAPE[-1], dim_expand=2.5, out_dim=6, activation="relu")
    x = _x(4)
    tm = tx.MLP2D(SHAPE[-1], 2.5, 6, activation="relu")
    assert tm.linear1.weight.shape == (20, SHAPE[-1], 1, 1)
    variables = _load(tm, jm.init(jax.random.PRNGKey(0), x))
    _close(tm(torch.from_numpy(x)), jm.apply(variables, x), "mlp2d")


@pytest.mark.parametrize("method", ["bilinear", "bicubic", "nearest"])
@pytest.mark.parametrize("kw", [{"scale_factor": 2.0}, {"scale_factor": 0.5}, {"size": (3, 7)},
                                {"size": (13, 4)}], ids=["up2", "down2", "mixed", "mixed2"])
def test_interpolate_matches_jax_image_resize(method, kw):
    """Half-pixel centres both ways, and antialiased when shrinking, as
    ``jax.image.resize``."""
    x = _x(5, (2, 12, 10, 3))
    want = jx.Interpolate(method=method, **kw).apply({}, jnp.asarray(x))
    got = tx.Interpolate(method=method, **kw)(torch.from_numpy(x))
    _close(got, want, f"{method} {kw}")
