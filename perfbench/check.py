"""The numbers that decide ``correct``: each a gap between what the timed
path produced and what the plain reference computes from the same inputs,
compared with the cell's limit (``limits/<cell>.json``, set from measured
readings of sound runs and of the lower-precision control). An entry
returns every reading; the cell's limits file names those compared."""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

import torch

QUIET_LEAF = 1e-3  # a leaf whose reference gradient is under this share of the median leaf's


def _rel(got: float, want: float, floor: float) -> float:
    return abs(got - want) / max(abs(want), floor, 1e-30)


def leaf_gaps(got: dict, want: dict, key: str, leaves) -> Dict[str, float]:
    """Each leaf's gap between the two norms under ``key``, over the larger
    of the reference leaf's norm and the median leaf's."""
    med = statistics.median(want[key][n] for n in leaves)
    return {n: _rel(got[key][n], want[key][n], med) for n in leaves}


def training_readings(got: dict, want: dict, rows=()) -> Dict[str, dict]:
    """Every stage-4 reading of the program (``got``) against the
    reference's: the worst step's relative loss gap; the worst and the
    median leaf's gap of the first-gradient norms and of the change norms
    (the change over leaves whose reference gradient is at least 1e-3 of the
    median leaf's: the others move by round-off alone); and
    ``change_rows_leaf``, the worst change gap among ``rows``, the leaves
    projected back onto rows after each update."""
    out = {"loss": {"value": max(_rel(g, w, 0.0) for g, w in zip(got["loss"], want["loss"])),
                    "at": "step"}}
    gmed = statistics.median(want["grad_norm"].values())
    moved = [n for n, g in want["grad_norm"].items() if g >= QUIET_LEAF * gmed]
    for key, leaves, name in (("grad_norm", list(want["grad_norm"]), "grad"),
                              ("change_norm", moved, "change")):
        gaps = leaf_gaps(got, want, key, leaves)
        worst = max(gaps, key=gaps.get)
        out[f"{name}_worst_leaf"] = {"value": gaps[worst], "at": worst}
        out[f"{name}_median_leaf"] = {"value": statistics.median(gaps.values()), "at": "median"}
        if name == "change":
            held = [n for n in rows if n in gaps]
            if held:
                worst = max(held, key=gaps.get)
                out["change_rows_leaf"] = {"value": gaps[worst], "at": worst}
    return out


def logit_gaps(got: torch.Tensor, want: torch.Tensor) -> Dict[str, dict]:
    """Served logits [n, K] against the reference's, each over the spread
    of the image's reference logits (max - min):

    * ``logit``: the worst image's largest gap;
    * ``top1_margin``: the widest gap by which the reference's logit of
      the served top class lies below the reference's best."""
    got, want = got.double(), want.double()
    spread = (want.amax(dim=1) - want.amin(dim=1)).clamp(min=1e-30)
    logit = ((got - want).abs().amax(dim=1) / spread)
    served = want.gather(1, got.argmax(dim=1, keepdim=True))[:, 0]
    margin = (want.amax(dim=1) - served) / spread
    return {"logit": {"value": float(logit.max()), "at": f"image {int(logit.argmax())}"},
            "top1_margin": {"value": float(margin.max()), "at": f"image {int(margin.argmax())}"}}


def atlas_gaps(got: dict, want: dict) -> Dict[str, dict]:
    """Stage 3's atlas rows of the sampled classes against the reference's:

    * ``vertex``: the worst class's largest gap between its vertex weights
      (each side's top ``V`` in descending order) over the reference's
      largest weight;
    * ``ingredients``: the worst class's share of codes that one side keeps
      and the other does not;
    * ``edge``: the worst class's largest edge gap over the codes both keep,
      over the reference's largest edge."""
    vertex, ingr, edge = [], [], []
    for c in range(want["vertex_weights"].shape[0]):
        gw, ww = got["vertex_weights"][c].double(), want["vertex_weights"][c].double()
        vertex.append(float((gw - ww).abs().max() / ww.abs().max().clamp(min=1e-30)))
        gi, wi = got["class_ingredients"][c].long(), want["class_ingredients"][c].long()
        common, gpos, wpos = _common(gi, wi)
        ingr.append(1.0 - len(common) / len(wi))
        if not common:  # no code in common: as far apart as two rows get
            edge.append(1.0)
            continue
        ge = got["edge_weights"][c].double()[gpos][:, gpos]
        we = want["edge_weights"][c].double()[wpos][:, wpos]
        edge.append(float((ge - we).abs().max() / want["edge_weights"][c].abs().max()
                          .clamp(min=1e-30)))
    return {name: {"value": max(vals), "at": f"class {vals.index(max(vals))}"}
            for name, vals in (("vertex", vertex), ("ingredients", ingr), ("edge", edge))}


def _common(a: torch.Tensor, b: torch.Tensor) -> Tuple[List[int], torch.Tensor, torch.Tensor]:
    pos_a = {int(c): i for i, c in enumerate(a.tolist())}
    pos_b = {int(c): i for i, c in enumerate(b.tolist())}
    common = sorted(set(pos_a) & set(pos_b))
    return (common, torch.tensor([pos_a[c] for c in common], dtype=torch.long),
            torch.tensor([pos_b[c] for c in common], dtype=torch.long))


def verdict(numbers: Dict[str, dict], limits: Dict[str, float]) -> Tuple[bool, List[dict]]:
    """(correct, rows): the numbers the cell's limits name, each beside its
    limit; one that is missing or not finite, or over its limit, fails.
    The other readings are not compared (PERF.md says why for each)."""
    if not limits:
        return False, []
    rows, ok = [], True
    for name, limit in limits.items():
        value = numbers.get(name, {}).get("value", float("nan"))
        ok &= math.isfinite(value) and value <= limit
        rows.append({"name": name, "value": value, "limit": limit,
                     "at": numbers.get(name, {}).get("at")})
    return ok, rows
