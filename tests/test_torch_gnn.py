"""The port's GNN embedding gradient, on the CPU: in bf16, and with the
class graphs' plan against the JAX GNN.

The JAX package sums the cotangent rows of duplicate ids in fp32 and rounds
once to the compute dtype (``schemanet_tpu/schema/gnn.py``
``_embed_lookup_bwd``). Summed in bf16 instead, the running sum stops growing
once the addends fall below half its ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from schemanet_torch.models.port import from_jax_params
from schemanet_torch.ops.kernels import embed_bwd as ek
from schemanet_torch.schema.gnn import GNN
from schemanet_tpu.schema.gnn import GNN as JaxGNN


def test_bf16_embedding_gradient_sums_duplicate_ids_in_fp32():
    """4,096 vertices all holding code 0, mean-pooled through an identity fc:
    every cotangent row is exactly 2^-12 in bf16 and they sum to exactly 1.
    A bf16 running sum stalls near 2^-4, where 2^-12 is below half an ulp."""
    n = 4096
    gnn = GNN(num_codes=3, embed_dim=2, num_layers=0, dtype=torch.bfloat16)
    with torch.no_grad():
        gnn.embedding.copy_(torch.randn(4, 2, generator=torch.Generator().manual_seed(0)))
        gnn.fc.weight.copy_(torch.eye(2))
        gnn.fc.bias.zero_()
    nodes = torch.ones(1, n, dtype=torch.bfloat16)
    ids = torch.zeros(1, n, dtype=torch.int32)
    out = gnn(nodes, torch.zeros(1, 1, 1, dtype=torch.bfloat16), ids)
    out.float().sum().backward()
    torch.testing.assert_close(gnn.embedding.grad, torch.tensor(
        [[1.0, 1.0], [0.0, 0.0], [0.0, 0.0], [0.0, 0.0]]), rtol=0, atol=0)


def test_gnn_class_plan_matches_jax():
    """The class graphs' GNN (every code once per class, the atlas's
    ``class_ingredients`` layout) with the atlas's ``PlannedIds``: the
    embeddings and every parameter's gradient within 1e-4 of max of the JAX
    GNN (its ``_embed_lookup_bwd``); the same bits as without the plan; the
    plan built once over two steps on the same buffer."""
    k, codes, d = 6, 24, 32
    rng = np.random.default_rng(5)
    nodes = rng.random((k, codes)).astype(np.float32)
    edges = rng.random((k, codes, codes)).astype(np.float32) / codes
    ids = np.tile(np.arange(codes, dtype=np.int32), (k, 1))
    gnn_j = JaxGNN(num_codes=codes, embed_dim=d, num_layers=2)
    args = tuple(jnp.asarray(a) for a in (nodes, edges, ids))
    params = jax.tree_util.tree_map(np.asarray, gnn_j.init(jax.random.PRNGKey(0), *args)["params"])

    def loss_j(p):
        return (gnn_j.apply({"params": p}, *args) ** 2).sum()

    out_j = gnn_j.apply({"params": params}, *args)
    grads_j = from_jax_params(jax.tree_util.tree_map(np.asarray, jax.grad(loss_j)(params)), {})

    gnn = GNN(num_codes=codes, embed_dim=d, num_layers=2)
    gnn.load_state_dict(from_jax_params(params, {}, gnn))
    buf = torch.from_numpy(ids)
    plans = ek.PlannedIds()
    grads = []
    for id_plans in (plans, plans, None):
        gnn.zero_grad()
        out = gnn(torch.from_numpy(nodes), torch.from_numpy(edges), buf, id_plans=id_plans)
        (out ** 2).sum().backward()
        grads.append({name: p.grad.clone() for name, p in gnn.named_parameters()})
        if id_plans is not None and len(grads) == 1:
            first_plan = plans._plan
    assert plans._plan is first_plan  # built once for the unchanged buffer
    scale = np.abs(out_j).max()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), rtol=0,
                               atol=1e-4 * scale)
    for name, got in grads[0].items():
        want = np.asarray(grads_j[name])
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)
        assert torch.equal(got, grads[1][name]) and torch.equal(got, grads[2][name])
