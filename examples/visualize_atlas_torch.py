#!/usr/bin/env python
"""Visualise IR-Atlas class graphs and per-image explanations from the
PyTorch port's files (the counterpart of ``examples/visualize_atlas.py``):

    python examples/visualize_atlas_torch.py \
        --bundle run/cifar_100/ingredient/deit_tiny-l9-M_1024/bundle \
        --ckpt run/cifar_100/schema_net/.../ckpt/best.pt \
        --schema-cfg configs/cifar_100/schema_net/deit_tiny-l9-M_1024.yaml \
        --num-classes 100 --class-id 3 --out atlas_class3.png --image images.npy

``--bundle`` is the port's bundle directory (``cli.py export``, or
``tools/convert_checkpoints.py bundle`` of a JAX bundle) and ``--ckpt`` a
checkpoint of the port's trained predictor. Writes the class knowledge
graph (node size = atlas vertex weight, edge width = adjacency weight) and,
with ``--image`` (a normalised NHWC ``.npy``), the per-token class
attribution heatmap of its first image beside it
(``<out>_attribution.png``). Needs matplotlib and networkx; ``--device``
picks where the predictor runs (CUDA unless ``cpu`` is given).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def plot_class_graph(atlas: dict, class_id: int, out_path: str, topk: int = 12) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import networkx as nx

    from schemanet_torch.schema.convert_graph import atlas_to_networkx

    g = atlas_to_networkx(atlas, class_id, node_topk=topk, edge_topk=5, node_threshold=0.0,
                          edge_threshold=0.0)
    if not g.nodes:
        print(f"class {class_id}: empty graph after thresholds", file=sys.stderr)
        return
    pos = nx.spring_layout(g, seed=0)
    weights = np.array([g.nodes[n]["weight"] for n in g.nodes])
    sizes = 300 + 3000 * weights / max(weights.max(), 1e-9)
    edge_w = np.array([d["weight"] for _, _, d in g.edges(data=True)])
    widths = 0.5 + 4 * edge_w / max(edge_w.max(), 1e-9) if len(edge_w) else []

    fig, ax = plt.subplots(figsize=(6, 6))
    nx.draw_networkx(g, pos, ax=ax, node_size=sizes, width=widths, node_color="#7aa6c2",
                     edge_color="#888888", font_size=8)
    ax.set_title(f"IR-Atlas class {class_id} (top-{topk} ingredients)")
    ax.axis("off")
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    print(f"wrote {out_path}")


def plot_attribution(attribution: np.ndarray, class_id: int, out_path: str) -> None:
    """The [H, W] token attribution of one image to ``class_id``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(4, 4))
    im = ax.imshow(attribution, cmap="viridis")
    fig.colorbar(im, ax=ax)
    ax.set_title(f"class {class_id} token attribution")
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    print(f"wrote {out_path}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--bundle", required=True)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--schema-cfg", required=True)
    p.add_argument("--num-classes", type=int, required=True)
    p.add_argument("--class-id", type=int, default=0)
    p.add_argument("--out", default="atlas.png")
    p.add_argument("--image", default=None, help="optional images (npy, normalised NHWC)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import torch

    from schemanet_torch.serve import load_serve_predictor
    from schemanet_torch.utils.config import get_cfg

    schema_cfg = get_cfg(args.schema_cfg).get("schema_net")
    server = load_serve_predictor(args.bundle, schema_cfg, args.ckpt,
                                  num_classes=args.num_classes, device=args.device)
    with torch.no_grad():
        atlas = {k: (v.float() if v.is_floating_point() else v).cpu().numpy()
                 for k, v in server.predictor.schema_net.get_atlas().items()}
    plot_class_graph(atlas, args.class_id, args.out)

    if args.image:
        res = server.explain(np.load(args.image)[:1])
        plot_attribution(res["attribution"][0, args.class_id], args.class_id,
                         os.path.splitext(args.out)[0] + "_attribution.png")


if __name__ == "__main__":
    main()
