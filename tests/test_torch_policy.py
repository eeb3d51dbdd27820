"""The port's kernel policy (``schemanet_torch/ops/policy.py``) against the
JAX package's (``schemanet_tpu/ops/policy.py``), and its routing, on the CPU.

* The fields, their choices, the ``SCHEMANET_*`` variables, the errors of an
  unknown key or value and the precedence (environment, then configuration,
  then ``auto``) equal the JAX package's; ``auto`` is the port's own (every
  hand kernel), not the JAX package's TPU winners.
* Each field's plain value reaches that field's plain function at its site,
  and its hand-kernel wrapper is not called; under ``auto`` the wrapper is
  (on the CPU it runs its plain version itself). Checked with spies.
* ``prng_impl: rbg`` and ``attn_pack: pair`` raise; the configuration's
  ``kernels:`` reaches the policy through the CLI and the workers.

Every test resets both packages' policy.
"""

import os
from unittest import mock

import numpy as np
import pytest
import torch

from schemanet_torch.models.attention import MultiHeadSelfAttention
from schemanet_torch.models.layers import MLP
from schemanet_torch.models.transformer import EncoderLayer, Transformer
from schemanet_torch.ops import policy
from schemanet_torch.ops import vq as port_vq
from schemanet_torch.ops.kernels import atlas_opt as ao
from schemanet_torch.ops.kernels import attention as ak
from schemanet_torch.ops.kernels import embed_bwd as ek
from schemanet_torch.ops.kernels import encoder_block as eb
from schemanet_torch.ops.kernels import graphconv as gc
from schemanet_torch.ops.kernels import layernorm as lnk
from schemanet_torch.ops.kernels import mlp as mk
from schemanet_torch.ops.kernels import vq as vqk
from schemanet_torch.schema.gnn import GNNLayer, GraphConv, embed_lookup
from schemanet_tpu.ops import policy as jax_policy

FIELDS = list(jax_policy._ENV)


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    for var in jax_policy._ENV.values():
        monkeypatch.delenv(var, raising=False)
    policy.reset_policy()
    jax_policy.reset_policy()
    yield
    policy.reset_policy()
    jax_policy.reset_policy()


def test_fields_choices_and_variables_equal_jax():
    assert [f.name for f in __import__("dataclasses").fields(policy.KernelPolicy)] == \
        [f.name for f in __import__("dataclasses").fields(jax_policy.KernelPolicy)]
    assert policy._ENV == jax_policy._ENV
    assert policy._CHOICES == jax_policy._CHOICES
    assert len(FIELDS) == 13
    assert set(policy.KERNEL_FIELDS) | {"symconv", "prng_impl", "attn_pack"} == set(FIELDS)


@pytest.mark.parametrize("kernels, err", [({"attn_backend": "xla"}, KeyError),
                                          ({"attn": "triton"}, ValueError),
                                          ({"vq": "interpret"}, ValueError),
                                          ({"symconv": "xla"}, ValueError)])
def test_unknown_keys_and_values_raise_as_in_jax(kernels, err):
    with pytest.raises(err):
        jax_policy.configure(kernels)
    with pytest.raises(err):
        policy.configure(kernels)


@pytest.mark.parametrize("field", FIELDS)
def test_precedence_equals_jax(field, monkeypatch):
    values = [v for v in policy._CHOICES[field] if v != "auto"
              and (field, v) not in policy._NO_COUNTERPART]
    configured, env = values[0], values[-1]
    for pkg in (policy, jax_policy):
        pkg.configure({field: configured})
    assert policy.resolve(field) == jax_policy.resolve(field) == configured
    monkeypatch.setenv(policy._ENV[field], env)
    assert policy.resolve(field) == jax_policy.resolve(field) == env
    monkeypatch.delenv(policy._ENV[field])
    for pkg in (policy, jax_policy):
        pkg.reset_policy()
    assert jax_policy.get_policy() == jax_policy.KernelPolicy()
    assert policy.get_policy() == policy.KernelPolicy()


def test_auto_takes_every_hand_kernel():
    assert policy.routes() == policy.Routes()
    assert all(getattr(policy.routes(), f) for f in policy.KERNEL_FIELDS)
    # the JAX package's TPU winners are not the port's
    assert jax_policy._AUTO_TPU["ln"] == "xla" and policy.resolve("ln") == "pallas"


@pytest.mark.parametrize("field, value", [("prng_impl", "rbg"), ("attn_pack", "pair")])
def test_no_counterpart_raises(field, value, monkeypatch):
    with pytest.raises(ValueError, match="not supported on the GPU"):
        policy.configure({field: value})
    monkeypatch.setenv(policy._ENV[field], value)
    with pytest.raises(ValueError, match="not supported on the GPU"):
        policy.refresh()
    monkeypatch.delenv(policy._ENV[field])
    other = next(v for v in policy._CHOICES[field] if v not in ("auto", value))
    policy.configure({field: other})  # every other value is accepted
    assert policy.routes() == policy.Routes()


def test_environment_is_read_when_the_routes_are_resolved(monkeypatch):
    """Sites read the snapshot: a variable set later counts from the next
    ``configure`` (which the CLI and the workers call), not launch by launch."""
    policy.configure(None)
    monkeypatch.setenv("SCHEMANET_VQ_BACKEND", "xla")
    assert policy.routes().vq
    policy.configure(None)
    assert not policy.routes().vq


# -- the sites -----------------------------------------------------------------

def _rand(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g)


def _attn():
    MultiHeadSelfAttention(2, 8).fused(_rand(2, 5, 8))


def _mlp():
    MLP(8, 16, "gelu").fused(_rand(2, 5, 8))


def _ln():
    Transformer(1, 2, 8, 16)._final_norm(_rand(2, 5, 8))


def _gnn_ln():
    GNNLayer(8)(_rand(2, 5, 5).abs(), _rand(2, 5, 8))


def _graphconv():
    GraphConv(8)(_rand(2, 5, 5).abs(), _rand(2, 5, 8))


def _vq():
    port_vq.vq_assign(_rand(7, 8), _rand(4, 8, seed=1))


def _embed(plans=None):
    table = _rand(6, 4).requires_grad_(True)
    embed_lookup(table, torch.tensor([[0, 1, 1], [5, 2, 1]]), plans).sum().backward()


def _block():
    layer = EncoderLayer(2, 8, 16)
    # the whole-layer route is taken on a CUDA tensor alone: stand one in
    with mock.patch.object(torch.Tensor, "is_cuda", new_callable=mock.PropertyMock,
                           return_value=True):
        layer(_rand(2, 5, 8))


def _atlas():
    from tests.test_torch_serve import _seeded_predictor, _trainer

    tr = _trainer(_seeded_predictor())
    rng = np.random.default_rng(0)
    tr.train_iter({"image": torch.from_numpy(rng.normal(size=(2, 16, 16, 3)).astype(np.float32)),
                   "label": torch.tensor([0, 3])})


# field: (plain value, site, (module, kernel wrapper), (module, plain function))
SITES = {
    "attn": ("xla", _attn, (ak, "fused_mhsa"), (ak, "fused_mhsa_reference")),
    "mlp": ("interpret", _mlp, (mk, "fused_mlp"), (mk, "fused_mlp_reference")),
    "ln": ("xla", _ln, (lnk, "fused_layernorm"), (lnk, "fused_layernorm_plain")),
    "gnn_ln": ("xla", _gnn_ln, (lnk, "fused_layernorm"), (lnk, "fused_layernorm_plain")),
    "graphconv": ("xla", _graphconv, (gc, "sym_conv"), (gc, "sym_conv_reference")),
    "vq": ("xla", _vq, (vqk, "vq_assign_kernel"), (vqk, "vq_assign_reference")),
    "embed_bwd": ("xla", _embed, (ek, "embed_grad"), (ek, "embed_grad_reference")),
    "static_embed_bwd": ("sorted_scatter", lambda: _embed(ek.PlannedIds()),
                         (ek, "embed_grad"), (ek, "embed_grad_reference")),
    "block": ("xla", _block, (eb, "attn_block"), (ak, "fused_mhsa")),
    "atlas_opt": ("xla", _atlas, (ao, "adamw_project_rows"),
                  (ao, "adamw_project_rows_reference")),
}


def _spied(site, kernel, plain):
    (km, kname), (pm, pname) = kernel, plain
    with mock.patch.object(km, kname, wraps=getattr(km, kname)) as k_spy, \
            mock.patch.object(pm, pname, wraps=getattr(pm, pname)) as p_spy:
        site()
    return k_spy.call_count, p_spy.call_count


@pytest.mark.parametrize("field", list(SITES))
def test_plain_value_reaches_the_plain_function(field):
    value, site, kernel, plain = SITES[field]
    k_auto, _ = _spied(site, kernel, plain)
    assert k_auto > 0, field  # auto: the hand-kernel wrapper
    policy.configure({field: value})
    k_plain, p_plain = _spied(site, kernel, plain)
    assert k_plain == 0 and p_plain > 0, (field, k_plain, p_plain)


def test_blocked_and_symconv_two_reach_their_plain_functions():
    policy.configure({"static_embed_bwd": "blocked"})
    assert _spied(lambda: _embed(ek.PlannedIds()), (ek, "embed_grad"),
                  (ek, "embed_grad_reference")) == (0, 1)
    policy.configure({"graphconv": "xla", "symconv": "two"})
    k, p = _spied(_graphconv, (gc, "sym_conv"), (gc, "sym_conv_two_reference"))
    assert k == 0 and p == 1
    e, f = _rand(3, 5, 5), _rand(3, 5, 8, seed=2)
    np.testing.assert_allclose(gc.sym_conv_two_reference(e, f).numpy(),
                               gc.sym_conv_reference(e, f).numpy(), rtol=1e-5, atol=1e-6)


def test_kernels_block_reaches_the_policy_from_the_cli_and_the_workers(tmp_path):
    from schemanet_torch import cli
    from schemanet_torch.train.workers import LaunchArgs, _split_cfg

    cfg = tmp_path / "cfg.json"
    cfg.write_text('{"kernels": {"ln": "xla"}}')
    with pytest.raises(KeyError, match="discretization"):  # after _setup, at the config
        cli.main(["extract", "--cfg", str(cfg), "--log-dir", str(tmp_path), "--device", "cpu",
                  "--ckpt", "c", "--save-path", str(tmp_path / "s"),
                  "--override", "kernels.graphconv=xla"])
    assert policy.resolve("ln") == "xla" and not policy.routes().ln
    assert policy.resolve("graphconv") == "xla" and not policy.routes().graphconv
    policy.reset_policy()
    _split_cfg({"kernels": {"vq": "xla"}, "dataset": {"name": "synthetic"}},
               LaunchArgs(base_dir=str(tmp_path)))
    assert not policy.routes().vq and policy.routes().ln
    assert os.environ.get("SCHEMANET_VQ_BACKEND") is None
