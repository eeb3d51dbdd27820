"""The port's losses against the JAX package's, values and gradients, fp32 on
the CPU: rtol 1e-5 / atol 1e-6 (the same fp32 arithmetic, summed in other
orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schemanet_torch.schema import loss as tl
from schemanet_tpu.schema import loss as jl


def _output(rng, k=4, v=6, b=5):
    vertices = rng.random((k, v)).astype(np.float32)
    edges = rng.random((k, v, v)).astype(np.float32)
    edges[0, 1] = 0.0  # zero entries: log(p + eps) stays finite
    return {"pred": rng.normal(size=(b, k)).astype(np.float32),
            "class_vertices": vertices / vertices.sum(-1, keepdims=True),
            "class_edges": edges / np.maximum(edges.sum(-1, keepdims=True), 1e-9)}


@pytest.mark.parametrize("name", ["ce_loss", "schema_inference_loss"])
def test_loss_terms_and_gradients_match_jax(name):
    rng = np.random.default_rng(0)
    out = _output(rng)
    label = rng.integers(0, 4, size=5).astype(np.int32)
    weights = {"cls": 1.0, "re_entropy_vertex": 0.5, "re_entropy_edge": 0.75}
    jax_fn = jl.get_loss_fn({"name": name})

    def jax_total(o):
        terms = jax_fn(o, {"label": jnp.asarray(label)})
        return jl.weighted_total(terms, weights), terms

    (want_total, want_terms), want_grads = jax.value_and_grad(jax_total, has_aux=True)(
        {k: jnp.asarray(v) for k, v in out.items()})
    out_t = {k: torch.from_numpy(v).requires_grad_() for k, v in out.items()}
    terms = tl.get_loss_fn({"name": name})(out_t, {"label": torch.from_numpy(label)})
    total = tl.weighted_total(terms, weights)
    total.backward()
    assert sorted(terms) == sorted(want_terms)
    for key, value in terms.items():
        np.testing.assert_allclose(value.item(), float(want_terms[key]), rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(total.item(), float(want_total), rtol=1e-5)
    for key, t in out_t.items():
        want = np.asarray(want_grads[key])
        got = np.zeros_like(want) if t.grad is None else t.grad.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=key)


def test_rectify_linear_matches_jax_on_both_sides():
    x = np.array([-1.0, 0.5, 2.9, 3.0, 3.1, 7.0], np.float32)
    np.testing.assert_allclose(tl.rectify_linear(torch.from_numpy(x), a=3.0).numpy(),
                               np.asarray(jl.rectify_linear(jnp.asarray(x), a=3.0)), rtol=1e-6)


def test_unknown_loss_is_refused():
    with pytest.raises(KeyError, match="not ported"):
        tl.get_loss_fn({"name": "distill_kl"})
