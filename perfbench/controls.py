"""The readings that set a cell's comparison limits, beside the benchmark's
own runs (which never run this):

* the control: the plain reference put in the program's place, computed in
  the precision below the configuration's (``fp8`` under bf16, ``tf32``
  under fp32), against the fp32 reference;
* planted faults of the cell's kind, in the reference put in the program's
  place: ``half_batch`` (a step or pass on the first half of each batch
  only, the mean taken over the rest); for training also ``double_lr``
  (every learning rate twice the configuration's) and ``skip_projection``
  (the atlas rows not projected back after an update); for serving
  ``permute_classes`` (class ``k``'s logit computed from class ``k - 1``'s
  graph);
* ``--program``: the program's own readings (sound runs): set-up, a window
  of ``--seconds`` (none for training, whose readings come from set-up's
  steps) and the comparison, seed after seed in one process.

    python3 perfbench/controls.py --workload <cell> --seeds 11,12,13 \\
        [--fault NAME] [--batches N] [--program --seconds S]

on the chip, at the cell's own sizes. One JSON line a seed: each number
the cell compares, and for training every reading (``check.training_readings``).
``--batches``: stage 3's batches a pass (a run's count).
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _halve(batches):
    return [{k: v[: len(v) // 2] for k, v in b.items()} for b in batches]


def _faulty_config(cfg: dict, fault: str) -> dict:
    out = copy.deepcopy(cfg)
    if fault == "double_lr":
        out["training"]["optimizer"]["lr"] *= 2
        for group in out["training"].get("param_groups") or []:
            if "lr" in (group.get("cfg") or {}):
                group["cfg"]["lr"] *= 2
    elif fault == "skip_projection":
        out["schema_net"]["ir_atlas"]["apply_normalize"] = False
    return out


def readings(cell, seed: int, device, precision: str, fault: str, batches: int) -> dict:
    """The control's (or fault's) numbers of one seed."""
    from perfbench import check, core, weights
    from perfbench.reference import model as ref
    from perfbench.reference.precision import Precision

    entry = core.entry_module(cell)
    cfg, t = cell.config, cell.traffic
    if cell.entry == "train":
        names = [k for k in weights.shapes(cfg)
                 if k.startswith((ref.ATLAS, ref.GNN)) and not k.endswith("class_ingredients")]
        want = entry.reference_readings(cfg, seed, device, t, names, "fp32")
        if fault is not None:
            pool = entry.pool(cfg, seed, device, t)[:t["check_steps"]]
            got = ref.train_steps(weights.make_weights(cfg, seed, device),
                                  _faulty_config(cfg, fault),
                                  _halve(pool) if fault == "half_batch" else pool,
                                  Precision("fp32"), names)
        else:
            got = entry.reference_readings(cfg, seed, device, t, names, precision)
        return check.training_readings(got, want, ref.projected_rows(cfg))
    if cell.entry == "serve":
        ids = entry.sample(t["pool_requests"] * 4, seed, t["sample_requests"])
        ids = [i % t["pool_requests"] for i in ids]
        want = entry.reference_logits(cfg, seed, device, t, ids, "fp32")
        if fault == "permute_classes":
            got = want.roll(1, dims=1)
        else:
            got = entry.reference_logits(cfg, seed, device, t, ids, precision)
        return check.logit_gaps(got, want)
    if cell.entry == "init":
        classes = entry.sample_classes(cfg, seed, t["sample_classes"], device)
        taken = list(range(batches))
        want = entry.reference_atlas(cfg, seed, device, t, taken, classes, "fp32")
        if fault == "half_batch":
            pool = entry.pool(cfg, seed, device, t)
            b = _halve([pool[i % len(pool)] for i in taken])
            got = ref.init_classes(weights.make_weights(cfg, seed, device), cfg, [b, b], classes,
                                   Precision("fp32"))
        else:
            got = entry.reference_atlas(cfg, seed, device, t, taken, classes, precision)
        return check.atlas_gaps(got, want)
    raise ValueError(f"no control for entry {cell.entry!r}")


class _Ctx:
    def __init__(self, cell, seed, seconds, device):
        self.cell, self.config, self.traffic = cell, cell.config, cell.traffic
        self.seed, self.seconds, self.device = seed, seconds, device
        self.reference_precision, self.trace = "fp32", None


def program_readings(cell, seed: int, device, seconds: float) -> dict:
    """A sound run's numbers: the entry's set-up, window and comparison."""
    import gc

    import torch

    from perfbench import check, core
    from perfbench.reference import model as ref

    entry = core.entry_module(cell)
    ctx = _Ctx(cell, seed, seconds, device)
    st = entry.setup(ctx)
    if cell.entry == "train":
        entry.release(st)
        gc.collect()
        torch.cuda.empty_cache()
        want = entry.reference_readings(cell.config, seed, device, cell.traffic, st["names"],
                                        "fp32")
        return check.training_readings(st["readings"], want, ref.projected_rows(cell.config))
    ctx.window = entry.window(st, ctx)
    gc.collect()
    return entry.compare(st, ctx)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--fault", default=None,
                   choices=(None, "half_batch", "double_lr", "skip_projection",
                            "permute_classes"))
    p.add_argument("--batches", type=int, default=300)
    p.add_argument("--program", action="store_true")
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import core

    cell = core.resolve(ROOT, args.workload)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    # the precision below the cell's: stage 3 runs fp32, the rest bf16
    precision = "tf32" if cell.entry == "init" else "fp8"
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if args.program:
            nums = program_readings(cell, seed, device, args.seconds)
        else:
            nums = readings(cell, seed, device, precision, args.fault, args.batches)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "precision": ("program" if args.program
                                        else None if args.fault else precision),
                          "fault": args.fault, "seconds": time.perf_counter() - t0,
                          "numbers": {k: v["value"] for k, v in nums.items()},
                          "at": {k: v.get("at") for k, v in nums.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
