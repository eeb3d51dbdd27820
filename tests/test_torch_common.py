"""``clip_by_global_norm`` of the port against ``optax.clip_by_global_norm``
on the same gradients, with the global norm below and above the limit.
Tolerance: equal when below (nothing changes); rtol 1e-6 above (the two
frameworks sum the squares in other orders)."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from schemanet_torch.train import clip_by_global_norm


def _grads(scale):
    rng = np.random.default_rng(0)
    return [(rng.normal(size=shape) * scale).astype(np.float32)
            for shape in ((7, 5), (5,), (3, 4, 2))]


@pytest.mark.parametrize("scale,max_norm", [(0.01, 1.0), (1.0, 0.1), (1.0, 1e3), (0.3, 0.1)])
def test_matches_optax(scale, max_norm):
    grads = _grads(scale)
    clipper = optax.clip_by_global_norm(max_norm)
    tree = [jnp.asarray(g) for g in grads]
    want = [np.asarray(g) for g in clipper.update(tree, clipper.init(tree))[0]]
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = clip_by_global_norm(got, max_norm)
    np.testing.assert_allclose(norm.item(), float(optax.global_norm(tree)), rtol=1e-6)
    for g, w, before in zip(got, want, grads):
        if norm.item() < max_norm:
            np.testing.assert_array_equal(g.numpy(), before)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=0)
    clipped = np.sqrt(sum(float((g.double() ** 2).sum()) for g in got))
    assert clipped <= max_norm * (1 + 1e-6)
