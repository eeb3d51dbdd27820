"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the chips the cell asks
for. Set-up (imports, CUDA context, the kernel library's load or build,
weights and inputs from the seed, the warm-up of the cell's shapes) is timed
from the process's start to the first timed step; the window then runs the
entry's work for ``--seconds``; after it the program's outputs are held
against the plain reference. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics, read from a
profile of a window of at most 10 s), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checked``: each compared number beside its limit, which also end
standard error.

Exit codes: 0 a result printed; 2 a cell or file the harness cannot find;
3 no CUDA device, or fewer than the cell asks for; 4 the program is not in
the checkout; 5 JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "perfbench" / "_cache"
TRACED_SECONDS = 10.0  # the traced window's length at most: a longer profile only costs parsing


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


class Context:
    """What an entry and a metric reader see of a run."""

    def __init__(self, cell, entry, seed, seconds, device):
        self.cell, self.entry, self.seed, self.seconds, self.device = (cell, entry, seed,
                                                                       seconds, device)
        self.config, self.traffic = cell.config, cell.traffic
        self.reference_precision = "fp32"
        self.setup_s = None
        self.window = None
        self.trace = None


def _finite(x):
    """A number for the result line; JSON has no NaN (a missing or
    non-finite compared number is null there, and fails)."""
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def _power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


class LayerRanges:
    """In the traced run: a ``record_function`` range ``perfbench.<layer>``
    around every forward of a module whose class is the layer's, opened in a
    forward pre-hook and closed in a forward hook."""

    def __init__(self, by_class):
        import torch

        self.by_class = by_class
        self.open = []
        mod = torch.nn.modules.module
        self.handles = [mod.register_module_forward_pre_hook(self._pre),
                        mod.register_module_forward_hook(self._post)]

    def _pre(self, module, args):
        layer = self.by_class.get(type(module).__name__)
        if layer is not None:
            from torch.autograd.profiler import record_function

            rf = record_function(f"perfbench.{layer}")
            rf.__enter__()
            self.open.append((module, rf))

    def _post(self, module, args, out):
        if self.open and self.open[-1][0] is module:
            self.open.pop()[1].__exit__(None, None, None)

    def remove(self):
        for h in self.handles:
            h.remove()


def run(argv=None) -> int:
    args = _args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench import check, core

    try:
        cell = core.resolve(ROOT, args.workload)
        entry = core.entry_module(cell)
    except (core.BenchError, KeyError) as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA device(s), found {have}",
              file=sys.stderr)
        return 3
    try:
        import schemanet_torch  # noqa: F401
    except ImportError as e:
        print(f"perfbench: the program is not in this checkout ({e})", file=sys.stderr)
        return 4

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    seconds = min(args.seconds, TRACED_SECONDS) if args.trace else args.seconds
    ctx = Context(cell, entry, args.seed, seconds, dev)
    state = entry.setup(ctx)
    torch.cuda.synchronize(dev)
    ctx.setup_s = time.perf_counter() - T0

    prof = ranges = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        ranges = LayerRanges(core.layer_ranges(m["name"] for m in cell.per_layer))
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.__enter__()
    ctx.window = entry.window(state, ctx)
    if prof is not None:
        prof.__exit__(None, None, None)
        ranges.remove()
        from perfbench import trace

        ctx.trace = trace.from_profiler(prof, ctx.window["seconds"])
        del prof
    peak = torch.cuda.max_memory_allocated(dev)

    loaded = core.forbidden_modules(sys.modules)
    if loaded:
        print(f"perfbench: loaded beside the port: {loaded}", file=sys.stderr)
        return 5
    metas = cell.per_layer if args.trace else cell.end_to_end
    metrics = {}
    for meta in metas:
        m = core.read_metric(meta, ctx)
        if m is not None and math.isfinite(m["value"]):
            metrics[meta["name"]] = m

    numbers = entry.compare(state, ctx)
    correct, rows = check.verdict(numbers, cell.limits)
    loaded = core.forbidden_modules(sys.modules)
    if loaded:
        print(f"perfbench: loaded beside the port: {loaded}", file=sys.stderr)
        return 5

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": cell.chips,
              "memory_peak_bytes": int(peak), "power_limit": _power_limit()}
    result = {"correct": bool(correct), "attempted": int(ctx.window["attempted"]),
              "failed": int(ctx.window["failed"]), "metrics": metrics, "device": device}
    if ctx.trace is not None:
        device["busy_s"] = ctx.trace.busy_s()
        device["window_s"] = ctx.trace.window_s
        result["breakdown"] = {"device_ops": ctx.trace.top_ops(10),
                               "idle_gaps": ctx.trace.idle_gaps(10)}
    result["checked"] = {r["name"]: {"value": _finite(r["value"]), "limit": r["limit"]}
                         for r in rows}
    print(json.dumps(result, allow_nan=False), flush=True)
    for name, n in numbers.items():
        if name not in cell.limits:
            print(f"reading {name} {n['value']!r} (not compared; {n.get('at')})", file=sys.stderr)
    for r in rows:
        print(f"checked {r['name']} {r['value']!r} limit {r['limit']!r} ({r['at']})",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(run())
