"""``BENCHMARK.json`` against the contract's rules, and every file its names
point to."""

from __future__ import annotations

import json
import re

import pytest

from perfbench import core

ROOT = core.BENCH_DIR.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = {w["name"]: w for w in MANIFEST["workloads"]}
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
LINE = re.compile(r"^[^\n\t]{1,200}$")


def reported(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_keys_and_sizes():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert 1 <= len(MANIFEST["workloads"]) <= 24 and 1 <= len(MANIFEST["configs"]) <= 24
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for path in MANIFEST["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", path) and ".." not in path
    assert len(MANIFEST["command"]) <= 32
    for word in MANIFEST["command"]:
        assert LINE.match(word) and not word.startswith("/")


def test_names_units_and_lines():
    names = ([c["name"] for c in MANIFEST["configs"]] + list(CELLS)
             + [m["name"] for m in METRICS])
    assert len(names) == len(set(names))
    for name in names + [w["traffic"] for w in CELLS.values()]:
        assert core.NAME.match(name), name
    for m in METRICS:
        assert core.UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "bound", "source", "layer", "moves",
                          "workloads"}
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["why"]) and LINE.match(c["source"]) and len(c["reduced"]) <= 16
    for w in CELLS.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and LINE.match(w["why"])


def test_bounds():
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in MANIFEST["end_to_end"])


def test_every_metric_cell_exists_and_reports_what_it_moves():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    for m in METRICS:
        assert set(m.get("workloads", CELLS)) <= set(CELLS), m["name"]
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e and LINE.match(m["layer"])
        for cell in CELLS:
            if reported(m, cell):
                assert reported(e2e[m["moves"]], cell), (m["name"], cell)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for cell in CELLS:
        e2e = [m["name"] for m in MANIFEST["end_to_end"] if reported(m, cell)]
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert any(reported(m, cell) for m in MANIFEST["per_layer"]), cell


def test_all_cells_on_one_chip():
    assert all(w["chips"] == 1 for w in CELLS.values())


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_every_file_a_cell_names_is_there(cell):
    c = core.resolve(ROOT, cell)
    assert (core.BENCH_DIR / "entries" / f"{c.entry}.py").is_file()
    for m in c.end_to_end + c.per_layer:
        assert hasattr(core.metric_module(m["name"]), "read"), m["name"]
    assert c.limits, f"no limits/{cell}.json"
    config_file = next(x["file"] for x in MANIFEST["configs"] if x["name"] == c.config_name)
    assert config_file.startswith("perfbench/") and c.config["reduced"] == []
