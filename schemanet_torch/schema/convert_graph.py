"""IR-Atlas -> NetworkX export for interpretability visualisation (port of
``schemanet_tpu/schema/convert_graph.py``; host code on numpy arrays,
``networkx`` imported inside the functions).

Reference ``schema_inference/graph/convert_graph.py:6-47``: keep the top-k
highest-weight vertices above a threshold, add edges from each kept vertex's
top-k strongest (upper-triangular) adjacency entries above the edge threshold.
"""

from __future__ import annotations

import numpy as np


def _numpy(x) -> np.ndarray:
    """A tensor (any device or dtype) or array as a numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
        x = x.float() if x.is_floating_point() else x
        return x.numpy()
    return np.asarray(x)


def to_networkx(
    node_weights: np.ndarray,  # [n]
    adj_matrix: np.ndarray,  # [n, n]
    edge_threshold: float,
    node_threshold: float,
    node_topk: int = 10,
    edge_topk: int = 5,
):
    import networkx as nx

    """Keep the ``node_topk`` heaviest nodes above ``node_threshold``; join
    kept nodes by each one's ``edge_topk`` strongest upper-triangular
    entries above ``edge_threshold``."""
    node_weights = np.asarray(_numpy(node_weights), np.float64)
    adj_matrix = np.asarray(_numpy(adj_matrix), np.float64)

    order = np.argsort(-node_weights)[:node_topk]
    keep = order[node_weights[order] > node_threshold]

    graph = nx.Graph()
    for node_id in keep:
        graph.add_node(int(node_id), weight=float(node_weights[node_id]))

    upper = np.triu(adj_matrix)
    kept = set(int(i) for i in keep)
    k = min(edge_topk, upper.shape[1])
    top_idx = np.argsort(-upper, axis=-1)[:, :k]
    for i in kept:
        for j in top_idx[i]:
            w = float(upper[i, j])
            if int(j) in kept and w > edge_threshold:
                graph.add_edge(int(i), int(j), weight=w)
    return graph


def atlas_to_networkx(
    atlas: dict,
    class_id: int,
    edge_threshold: float = 0.0,
    node_threshold: float = 0.0,
    node_topk: int = 10,
    edge_topk: int = 5,
):
    """Convenience: export one class graph from a ``get_atlas()`` dict (of
    numpy arrays or tensors), relabeling local slots to global ingredient
    ids."""
    import networkx as nx

    g = to_networkx(
        _numpy(atlas["class_vertices"][class_id]),
        _numpy(atlas["class_edges"][class_id]),
        edge_threshold,
        node_threshold,
        node_topk,
        edge_topk,
    )
    mapping = {
        slot: int(code)
        for slot, code in enumerate(_numpy(atlas["class_ingredients"][class_id]))
        if slot in g.nodes
    }
    return nx.relabel_nodes(g, mapping)
