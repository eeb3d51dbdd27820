"""A new cell, traffic mix, entry kind or metric is found by its name with
no file of the harness edited."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

from perfbench import core

ROOT = core.BENCH_DIR.parent


def test_a_new_cell_is_found_without_an_edit(tmp_path):
    shutil.copytree(core.BENCH_DIR, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    manifest["workloads"].append({"name": "in_small.train_b32", "config": "imagenet_deit_small",
                                  "traffic": "train_b32", "chips": 1, "why": "a new cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    traffic = json.loads((core.BENCH_DIR / "traffic" / "train_b64.json").read_text())
    (tmp_path / "perfbench" / "traffic" / "train_b32.json").write_text(
        json.dumps(dict(traffic, batch=32)))
    (tmp_path / "perfbench" / "metrics" / "steps_done.py").write_text(
        "def read(ctx):\n    return ctx.window['steps']\n")
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*.py")}
    # the copy's harness, in a process of its own, resolves the new cell
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from perfbench import core; "
            "c = core.resolve(sys.argv[1], 'in_small.train_b32'); "
            "print(c.entry, c.traffic['batch'], c.config['num_classes'], "
            "core.metric_module('steps_done').read(type('C', (), {'window': {'steps': 3}})))")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                         text=True, check=True).stdout.split()
    assert out == ["train", "32", "1000", "3"]
    assert all(p.read_bytes() == b for p, b in before.items())


def test_a_missing_cell_is_refused():
    try:
        core.resolve(ROOT, "no_such_cell")
    except core.BenchError as e:
        assert "no_such_cell" in str(e)
    else:
        raise AssertionError("resolve took a cell BENCHMARK.json does not name")


def test_a_split_metric_is_read_by_the_file_of_its_stem():
    assert core.metric_module("mfu.train").__file__.endswith("mfu.py")
    assert core.metric_module("idle_share.pass").__file__.endswith("idle_share.py")
    assert core.metric_module("vit.roofline.pass").__file__.endswith("vit.roofline.pass.py")


def test_layer_ranges_come_from_the_cells_metric_files():
    for cell in ("in_small.serve", "in_small.init", "in_small.train"):
        c = core.resolve(ROOT, cell)
        ranges = core.layer_ranges(m["name"] for m in c.per_layer)
        want = {"in_small.serve": {"IngredientBackbone": "vit", "Matcher": "gnn"},
                "in_small.init": {"IngredientBackbone": "vit"}, "in_small.train": {}}[cell]
        assert ranges == want, cell
