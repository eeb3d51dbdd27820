"""The port's ``ServePredictor.explain``, ``explain_networkx`` and
``load_serve_predictor`` against the JAX package's, on the CPU.

The same numpy images go through ``schemanet_tpu.serve.ServePredictor`` (its
frozen forward on the Pallas block kernels in interpret mode) and through
``schemanet_torch.serve.ServePredictor`` loaded with the converted variables;
fp32 with ``graph_precision='highest'``. Ids and slot codes must be equal;
floats within rtol 1e-4 and atol 1e-4 x max (the tolerance and its reasoning
of ``test_torch_serve.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from schemanet_torch.models.port import from_jax_params
from schemanet_torch.schema import build_predictor as torch_build_predictor
from schemanet_torch.schema.convert_graph import atlas_to_networkx
from schemanet_torch.serve import EXPLAIN_KEYS, ServePredictor, code_weight_table
from schemanet_tpu.ops import geometry as jax_geometry
from schemanet_tpu.ops import policy
from schemanet_tpu.schema import build_predictor as jax_build_predictor
from schemanet_tpu.schema.convert_graph import atlas_to_networkx as jax_atlas_to_networkx
from schemanet_tpu.serve import ServePredictor as JaxServePredictor

from tests.test_torch_serve import D, ENCODE_LAYER, K, M, MODEL_CFG, SCHEMA_CFG

EXACT = ("ingredients", "instance_ingredients")


@pytest.fixture(autouse=True)
def _kernel_policy():
    policy.reset_policy()
    policy.configure({"block": "interpret", "attn": "interpret", "graphconv": "interpret"})
    yield
    policy.reset_policy()


@pytest.fixture(scope="module")
def servers():
    """(JAX server, port server, images): class 0 holds code 3 twice."""
    predictor = jax_build_predictor(MODEL_CFG, SCHEMA_CFG, K, M, D, ENCODE_LAYER)
    jax_geometry.pairwise_point_sim(4, 4, 1.0, 2.0)
    variables = jax.jit(lambda key, x: predictor.init(key, x, method="init_full"))(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    params = jax.tree_util.tree_map(np.asarray, dict(variables["params"]))
    params["matcher"]["gnn"]["fc"]["bias"] = (
        np.random.default_rng(7).normal(size=(16,)).astype(np.float32))
    buffers = jax.tree_util.tree_map(lambda x: np.array(x), dict(variables["buffers"]))
    ci = buffers["schema_net"]["class_ingredients"]
    ci[0, 5] = ci[0, 3]  # a genuine duplicate: both slots' weights add
    model = torch_build_predictor(MODEL_CFG, SCHEMA_CFG, K, M, D, ENCODE_LAYER)
    model.load_state_dict(from_jax_params(params, buffers, model), strict=True)
    images = np.random.default_rng(0).normal(size=(6, 16, 16, 3)).astype(np.float32)
    return (JaxServePredictor(predictor, params, buffers, microbatch=4),
            ServePredictor(model, microbatch=4, device="cpu"), images)


@pytest.fixture(scope="module")
def explained(servers):
    jax_server, server, images = servers
    return jax_server.explain(images), server.explain(images)


@pytest.mark.parametrize("key", EXPLAIN_KEYS)
def test_explain_matches_jax(explained, key):
    want, got = explained
    assert got[key].shape == want[key].shape, key
    if key in EXACT:
        np.testing.assert_array_equal(got[key], want[key])
    else:
        scale = np.abs(want[key]).max()
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-4 * scale)


def test_explain_attribution_sums_a_duplicate_code(servers, explained):
    """The table adds both slots of class 0's duplicate code, as the JAX
    table does; every token with that code reads the sum."""
    _, server, _ = servers
    _, got = explained
    with torch.no_grad():
        atlas = server.predictor.schema_net.get_atlas()
    ci = atlas["class_ingredients"]
    code = int(ci[0, 3])
    assert int(ci[0, 5]) == code
    table = code_weight_table(atlas["class_vertices"], ci, M)
    want = float(atlas["class_vertices"][0, 3] + atlas["class_vertices"][0, 5])
    assert float(table[0, code]) == pytest.approx(want, rel=1e-6)
    hits = got["ingredients"] == code
    assert hits.any()
    np.testing.assert_array_equal(got["attribution"][:, 0][hits], np.float32(table[0, code]))


def test_explain_pred_equals_predict(servers, explained):
    _, server, images = servers
    _, got = explained
    np.testing.assert_allclose(got["pred"], server.predict(images), rtol=0, atol=0)


def test_explain_tensor_builds_no_match_tensor(servers):
    """The attribution is [n, K, H, W] and the largest intermediate the
    explain path allocates is of the order of the [K, M+1] table or the
    attribution, not [n, K, L, V_max]."""
    _, server, images = servers
    out = server.explain_tensor(torch.from_numpy(images))
    assert tuple(out["attribution"].shape) == (6, K, 4, 4)
    assert out["attribution"].dtype == torch.float32


def _graph_sets(g):
    nodes = {n: d["weight"] for n, d in g.nodes(data=True)}
    edges = {tuple(sorted(e[:2])): e[2]["weight"] for e in g.edges(data=True)}
    return nodes, edges


def _same_graph(got, want):
    gn, ge = _graph_sets(got)
    wn, we = _graph_sets(want)
    assert gn.keys() == wn.keys() and ge.keys() == we.keys()
    for key in wn:
        assert gn[key] == pytest.approx(wn[key], abs=1e-6)
    for key in we:
        assert ge[key] == pytest.approx(we[key], abs=1e-6)


@pytest.mark.parametrize("sample", [0, 5])
def test_explain_networkx_matches_jax(servers, sample):
    jax_server, server, images = servers
    _same_graph(server.explain_networkx(images, sample=sample),
                jax_server.explain_networkx(images, sample=sample))


def test_atlas_to_networkx_matches_jax(servers):
    jax_server, server, images = servers
    out = jax_server.predictor.apply({"params": jax_server.params, "buffers": jax_server.buffers},
                                     jnp.asarray(images[:1]))
    want_atlas = {k: np.asarray(out[k]) for k in ("class_vertices", "class_edges",
                                                  "class_ingredients")}
    with torch.no_grad():
        got_atlas = server.predictor.schema_net.get_atlas()
    for class_id in range(K):
        _same_graph(atlas_to_networkx(got_atlas, class_id, node_topk=6, edge_topk=3),
                    jax_atlas_to_networkx(want_atlas, class_id, node_topk=6, edge_topk=3))


def test_load_serve_predictor_on_worker_files(tmp_path):
    """A server from the files the port's stages and ``schema_net_worker``
    write gives the trained predictor's logits and explanations bit for bit."""
    from schemanet_torch.pipeline import (extract_stage, init_stage, save_atlas_init,
                                          save_bundle)
    from schemanet_torch.serve import load_serve_predictor
    from schemanet_torch.train import LaunchArgs, schema_net_worker

    batch = {"image": np.random.default_rng(1).normal(size=(4, 16, 16, 3)),
             "label": np.array([0, 1, 2, 3])}
    ds = {"name": "synthetic", "num_classes": K, "image_size": 8, "resize": 16,
          "train": {"num_samples": 8}, "val": {"num_samples": 4}}
    bundle = extract_stage({"dataset": ds, "model": MODEL_CFG,
                            "discretization": {"vocabulary": {"size": M},
                                               "encoder_layer": ENCODE_LAYER}},
                           [batch], device="cpu", max_features=64, lloyd_iters=1)
    schema_cfg = dict(SCHEMA_CFG)
    atlas = init_stage({"dataset": ds, "schema_net": schema_cfg}, bundle, [batch], device="cpu")
    bundle_dir, atlas_fp = str(tmp_path / "bundle"), str(tmp_path / "atlas.pt")
    save_bundle(bundle_dir, bundle.model_cfg, bundle.encode_layer, bundle.backbone_state,
                bundle.codebook)
    save_atlas_init(atlas_fp, atlas["params"], atlas["class_ingredients"])
    cfg = {
        "dataset": ds,
        "training": {"train_epochs": 1, "batch_size": 4, "num_workers": 1,
                     "optimizer": {"name": "AdamW", "lr": 1e-3}},
        "validation": {"batch_size": 4, "num_workers": 1},
        "schema_net": dict(schema_cfg, bundle=bundle_dir, initial_state_fp=atlas_fp),
        "loss": {"name": "schema_inference_loss", "weight_dict": {"cls": 1.0}},
    }
    out = schema_net_worker(cfg, LaunchArgs(log_dir=str(tmp_path / "run"), device="cpu"))
    trained = ServePredictor(out["predictor"], microbatch=4, device="cpu")
    images = np.random.default_rng(2).normal(size=(5, 16, 16, 3)).astype(np.float32)
    ckpt_dir = tmp_path / "run" / "ckpt"

    def load(ckpt):
        return load_serve_predictor(bundle_dir, cfg["schema_net"], str(ckpt), K, microbatch=4,
                                    device="cpu")

    for ckpt in (ckpt_dir / "iter-2", ckpt_dir / "iter-2.pt"):  # the last tag: the trained model
        server = load(ckpt)
        np.testing.assert_array_equal(server.predict(images), trained.predict(images))
    got, want = server.explain(images), trained.explain(images)
    for key in EXPLAIN_KEYS:
        np.testing.assert_array_equal(got[key], want[key])
    # a directory takes its best tag
    np.testing.assert_array_equal(load(ckpt_dir).predict(images),
                                  load(ckpt_dir / "best").predict(images))


@pytest.mark.parametrize("method", ["full_vertices", "limited_edges", "build_instance_graphs"])
def test_graph_methods_match_jax(servers, method):
    """Stage 3's per-image passes and the graphs without matching, on the
    predictor's own atlas attribute weights and class_ingredients."""
    jax_server, server, images = servers
    variables = {"params": jax_server.params, "buffers": jax_server.buffers}
    labels = np.array([0, 1, 2, 3, 4, 0])
    args = (images,) + ((labels,) if method == "limited_edges" else ())
    want = jax_server.predictor.apply(variables, *map(jnp.asarray, args), method=method)
    got = getattr(server.predictor, method)(*map(torch.from_numpy, args))
    if method == "build_instance_graphs":
        want, got = want["instance"], got["instance"]
        assert set(got) == set(want)
    else:
        want, got = {method: want}, {method: got}
    for key, w in want.items():
        w, g = np.asarray(w), got[key].numpy()
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max(), err_msg=key)
