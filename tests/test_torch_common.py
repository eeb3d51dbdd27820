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


# ---------------------------------------------------------------------------
# adamw_lowmem (schemanet_tpu/train/common.py) against the port's
# make_optimizer: 5 steps of both on the same parameters and gradients.
# Parameters within 1e-6 of max |p| (the frameworks' fp32 pow in the bias
# corrections and lr_t may differ in the last bit); bf16 moments within one
# bf16 ulp of JAX's (a last-bit fp32 difference in the sum can flip the
# rounding); full fp32 moments of the low-memory updates bit for bit (the
# same fp32 operations in the same order); factored row/col statistics
# within 1e-6 relative (sums over a row or column, in each framework's
# order); the groups on torch.optim.AdamW (no low-memory key) within 1e-6
# relative (torch updates m by lerp, optax by b1 m + (1 - b1) g).
# ---------------------------------------------------------------------------
import jax  # noqa: E402
from torch import nn  # noqa: E402

from schemanet_torch.train.common import make_optimizer  # noqa: E402
from schemanet_tpu.train.common import make_optimizer as jax_make_optimizer  # noqa: E402

_SHAPES = {("schema_net", "edge_weights"): (3, 40, 40), ("schema_net", "vertex_weights"): (3, 40),
           ("head", "bias"): (8,), ("head", "embedding"): (6, 5)}
_LOWMEM_CASES = {
    # the ImageNet stage-4 YAML's schema_net group: bf16 mu and nu
    "bf16_mu_nu": ({"lr": 1e-3, "weight_decay": 0.05},
                   [{"pattern": "schema_net", "cfg": {"weight_decay": 5e-4,
                                                      "moment_dtype": "bfloat16",
                                                      "nu_dtype": "bfloat16"}}]),
    # bf16 mu alone, top level: optax.adamw(mu_dtype=bfloat16) on every group
    "bf16_mu_top": ({"lr": 1e-3, "weight_decay": 0.05, "moment_dtype": "bfloat16"}, []),
    # factored nu where both trailing dims are >= 16 (the edge weights)
    "factored": ({"lr": 1e-3, "weight_decay": 0.05},
                 [{"pattern": "schema_net", "cfg": {"nu_factored_min_size": 16}}]),
    # no low-memory key: optax.adamw
    "none": ({"lr": 1e-3, "weight_decay": 0.05},
             [{"pattern": "schema_net", "cfg": {"weight_decay": 5e-4}}]),
}


class _Holder(nn.Module):
    def __init__(self, values):
        super().__init__()
        for (mod, leaf), v in values.items():
            if not hasattr(self, mod):
                setattr(self, mod, nn.Module())
            getattr(self, mod).register_parameter(leaf, nn.Parameter(torch.from_numpy(v.copy())))


def _adam_states(state, out=None):
    """Every optax ScaleByAdamState in an optimizer state, in tree order."""
    out = [] if out is None else out
    if isinstance(state, optax.ScaleByAdamState):
        out.append(state)
    elif isinstance(state, (tuple, list)):
        for s in state:
            _adam_states(s, out)
    elif isinstance(state, dict):
        for k in sorted(state):
            _adam_states(state[k], out)
    elif hasattr(state, "inner_states"):
        _adam_states(state.inner_states, out)
    elif hasattr(state, "inner_state"):
        _adam_states(state.inner_state, out)
    return out


def _ulp_bf16(x):
    x = np.abs(np.asarray(x, np.float32))
    return np.exp2(np.floor(np.log2(np.maximum(x, np.finfo(np.float32).tiny))) - 7)


@pytest.mark.parametrize("case", list(_LOWMEM_CASES))
def test_lowmem_adamw_matches_jax(case):
    opt_cfg, groups = _LOWMEM_CASES[case]
    rng = np.random.default_rng(7)
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in _SHAPES.items()}
    grads = [{k: (rng.normal(size=s) * 10.0 ** rng.integers(-4, 0)).astype(np.float32)
              for k, s in _SHAPES.items()} for _ in range(5)]

    def schedule(step):
        return 1e-3 * (1.0 - 0.1 * step)

    jparams = {m: {leaf: jnp.asarray(init[(m, leaf)]) for (mm, leaf) in _SHAPES if mm == m}
               for m in ("schema_net", "head")}
    tx, _ = jax_make_optimizer(jparams, opt_cfg, schedule, groups)
    jstate = tx.init(jparams)
    update = jax.jit(tx.update)  # as the JAX trainer's step runs it

    model = _Holder(init)
    opt, labels, hyper = make_optimizer(model, opt_cfg, schedule, groups)
    named = dict(model.named_parameters())
    for step, gr in enumerate(grads):
        jg = {m: {leaf: jnp.asarray(gr[(m, leaf)]) for (mm, leaf) in _SHAPES if mm == m}
              for m in ("schema_net", "head")}
        upd, jstate = update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for (m, leaf), g in gr.items():
            named[f"{m}.{leaf}"].grad = torch.from_numpy(g.copy())
        opt.step(step)
        for (m, leaf) in _SHAPES:
            want, got = np.asarray(jparams[m][leaf]), named[f"{m}.{leaf}"].detach().numpy()
            assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), (case, step, m, leaf)

    # the moments after 5 steps, leaf by leaf: JAX's per label, in tree order
    torch_state = {}
    if opt.lowmem is not None:
        for (hp, ps), states in zip(opt.lowmem.groups, opt.lowmem.state):
            for p, st in zip(ps, states):
                torch_state[next(n for n, q in named.items() if q is p)] = (st, hp.moments)
    jax_leaves = {}
    for adam in _adam_states(jstate):
        flat_mu = jax.tree_util.tree_flatten_with_path(adam.mu)[0]
        for path, mu in flat_mu:
            name = ".".join(str(getattr(k, "key", k)) for k in path)
            nu = adam.nu
            for k in path:
                nu = nu[getattr(k, "key", k)]
            jax_leaves[name] = (mu, nu)
    assert set(jax_leaves) == set(named)
    for name, (mu, nu) in jax_leaves.items():
        if name in torch_state:
            st, moments = torch_state[name]
            m = st["m"]
            assert m.dtype == (moments.mu_dtype or torch.float32), name
            v = {"full": st["v"]} if "v" in st else {"row": st["row"], "col": st["col"]}
            if not isinstance(nu, dict):
                nu = {"full": nu}
        else:  # torch.optim.AdamW
            slot = opt.optimizer.state[named[name]]
            m, v = slot["exp_avg"], {"full": slot["exp_avg_sq"]}
            if not isinstance(nu, dict):
                nu = {"full": nu}
        assert set(v) == set(nu), name
        for t, w in ((m, mu), *((v[k], nu[k]) for k in nu)):
            w = np.asarray(jnp.asarray(w, jnp.float32))
            got = t.float().numpy()
            assert t.dtype == {jnp.bfloat16: torch.bfloat16}.get(
                jnp.asarray(mu if t is m else nu[next(iter(nu))]).dtype.type, torch.float32) \
                or t.dtype in (torch.float32, torch.bfloat16), name
            if t.dtype == torch.bfloat16:
                assert (np.abs(got - w) <= _ulp_bf16(w)).all(), (case, name)
            elif name not in torch_state:
                np.testing.assert_allclose(got, w, rtol=1e-6, atol=1e-6 * np.abs(w).max(),
                                           err_msg=f"{case} {name}")
            elif t.shape != named[name].shape:  # factored statistics
                np.testing.assert_allclose(got, w, rtol=1e-6, err_msg=f"{case} {name}")
            else:
                np.testing.assert_array_equal(got, w, err_msg=f"{case} {name}")


@pytest.mark.parametrize("cfg", [{"name": "AdamW", "factored": True}, {"name": "adam"},
                                 {"name": "sgd"}])
def test_unported_optimizers_raise(cfg):
    with pytest.raises(NotImplementedError):
        make_optimizer(_Holder({("head", "bias"): np.zeros(3, np.float32)}), cfg, lambda s: 1e-3)
