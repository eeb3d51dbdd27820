"""The harness's data: ``BENCHMARK.json``, and the files each of its names
points to, found by name.

* a configuration: ``BENCHMARK.json``'s ``file`` (``configs/<config>.json``);
* a traffic mix: ``traffic/<traffic>.json``, whose ``entry`` names the
  entry kind, ``entries/<entry>.py``;
* a metric, end-to-end or per-layer: ``metrics/<metric>.py`` (or the file
  of its name's first dotted parts), whose ``read(ctx)`` gives the number
  or None (nothing to read), and whose ``RANGE`` names the layer range the
  traced run opens around a module class's forwards;
* a cell's comparison limits: ``limits/<cell>.json``.

A later cell, configuration, traffic mix, entry kind or metric is a new
file and a new entry in ``BENCHMARK.json``: no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN_TOP = ("jax", "jaxlib", "flax", "schemanet_tpu")


class BenchError(RuntimeError):
    """A cell the harness cannot run as asked."""


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    chips: int
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    limits: Dict[str, float]

    @property
    def entry(self) -> str:
        return self.traffic["entry"]


def load_manifest(root: Path) -> Dict[str, Any]:
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise BenchError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def _reports(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _json(path: Path, what: str) -> Dict[str, Any]:
    if not path.is_file():
        raise BenchError(f"{what}: no file {path}")
    return json.loads(path.read_text())


def resolve(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root``'s ``BENCHMARK.json``, its files read."""
    root = Path(root)
    manifest = load_manifest(root)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise BenchError(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    conf = configs[w["config"]]
    limits_path = BENCH_DIR / "limits" / f"{workload}.json"
    return Cell(
        name=workload, config_name=w["config"], config=_json(root / conf["file"], w["config"]),
        traffic=_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json", w["traffic"]),
        chips=int(w["chips"]),
        end_to_end=[m for m in manifest["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in manifest["per_layer"] if _reports(m, workload)],
        limits=_json(limits_path, f"limits of {workload}") if limits_path.is_file() else {})


def load_file_module(path: Path, name: str):
    """A module from its file, whatever its name's characters."""
    if not path.is_file():
        raise BenchError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry_module(cell: Cell):
    return load_file_module(BENCH_DIR / "entries" / f"{cell.entry}.py",
                            f"perfbench_entry_{cell.entry}")


def metric_module(name: str):
    """``metrics/<name>.py``, else the file of the name with its last dotted
    parts taken off (``mfu.train`` -> ``metrics/mfu.py``): one reader for a
    quantity split by what it moves."""
    stem = name
    while not (BENCH_DIR / "metrics" / f"{stem}.py").is_file() and "." in stem:
        stem = stem.rsplit(".", 1)[0]
    return load_file_module(BENCH_DIR / "metrics" / f"{stem}.py",
                            "perfbench_metric_" + re.sub(r"\W", "_", stem))


def layer_ranges(names) -> Dict[str, str]:
    """module class name -> layer: the ``RANGE`` (layer, class name) of
    each of these metrics' readers that brackets a layer's forwards."""
    out = {}
    for name in names:
        rng = getattr(metric_module(name), "RANGE", None)
        if rng is not None:
            out[rng[1]] = rng[0]
    return out


def forbidden_modules(modules) -> List[str]:
    """The loaded modules whose whole top-level name is forbidden beside the
    port (``jax``, ``jaxlib``, ``flax``, the JAX package): ``schemanet_torch``
    is not ``schemanet_tpu``, nor is ``jaxtyping`` ``jax``."""
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN_TOP)


def read_metric(meta: Dict[str, Any], ctx) -> Optional[Dict[str, Any]]:
    value = metric_module(meta["name"]).read(ctx)
    if value is None:
        return None
    return {"value": float(value), "unit": meta["unit"]}
