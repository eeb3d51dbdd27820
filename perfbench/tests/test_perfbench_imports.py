"""What the benchmark loads: nothing whose whole top-level name is
``jax``, ``jaxlib``, ``flax`` or the JAX package, and a reference that
imports nothing of the port."""

from __future__ import annotations

import ast
import subprocess
import sys

from perfbench import core

ROOT = core.BENCH_DIR.parent


def test_names_are_compared_whole():
    mods = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "schemanet_tpu.ops",
            "schemanet_torch", "schemanet_torch.ops", "jaxtyping", "flaxish", "schemanet_tpu2"]
    assert core.forbidden_modules(mods) == ["flax.linen", "jax", "jax.numpy",
                                            "jaxlib.xla_client", "schemanet_tpu.ops"]


def test_a_run_loads_no_jax():
    """Every module a run imports (the harness, each entry and metric, the
    port's modules the entries build) in one process: none is forbidden."""
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
from perfbench import core, check, trace, work, weights, program
import perfbench.run
for p in sorted((core.BENCH_DIR / "entries").glob("*.py")):
    core.load_file_module(p, "e_" + p.stem)
for p in sorted((core.BENCH_DIR / "metrics").glob("*.py")):
    core.metric_module(p.stem)
import schemanet_torch.schema, schemanet_torch.train, schemanet_torch.serve
import schemanet_torch.pipeline.stages, schemanet_torch.pipeline.bundle
bad = core.forbidden_modules(sys.modules)
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr


def test_the_reference_imports_nothing_of_the_port():
    for path in (core.BENCH_DIR / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("schemanet_torch", "schemanet_tpu", "jax"), \
                    (path.name, name)
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            "import perfbench.reference.model, perfbench.reference.precision; "
            "sys.exit(any(m.split('.')[0] in ('schemanet_torch', 'schemanet_tpu', 'jax') "
            "for m in sys.modules))")
    assert subprocess.run([sys.executable, "-c", code]).returncode == 0
