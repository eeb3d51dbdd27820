"""The verdict of the port's accuracy gates (``tools/ab_graph_precision_torch.sh``,
``tools/ab_atlas_moments_torch.sh``), from the files the gate scripts write
under their run directory.

Each arm is ``name=<log>``: the stage-4 ``schema_net_worker``'s output, whose
last ``final eval: {1: top-1, 5: top-5}`` line is the arm's result (the
training steps: its ``ckpt/meta.json`` ``iter``, the log being
``<run>/<stage>.stdout`` beside the stage's log directory ``<run>/<stage>``).
Prints ``<arm>: final eval: {...}`` a line, as the JAX gates do, then one
JSON line: each arm's top-1 and top-5, its gap to the baseline and its
verdict, ``eval_worker``'s counts against the baseline's final eval, each
stage's exit code and seconds (``<run>/stages.txt``), and ``pass``. The rules:

* the baseline reaches ``FLOOR`` top-1 (ten times chance at K 100), so two
  untrained arms cannot pass;
* a gated arm's top-1 is within ``GAP`` (0.5 pt) of the baseline's;
* ``--eval``: ``eval_worker`` on the baseline's best checkpoint gives the
  baseline's final-eval counts exactly;
* a reported arm is reported, not gated.

Exits 1 when a rule fails, 2 when a log lacks its line.

    python3 tools/ab_verdict_torch.py --gate NAME --run DIR --baseline ARM=LOG
        [--gated ARM=LOG ...] [--reported ARM=LOG ...] [--eval LOG]
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import re
import sys

GAP = 0.005  # "within 0.5 pt" of top-1
FLOOR = 0.10  # the baseline's least top-1


def last_dict(path: str, marker: str) -> dict:
    """The dict literal after the last ``marker`` in the file ``path``."""
    with open(path) as f:
        found = re.findall(re.escape(marker) + r" (\{.*\})", f.read())
    if not found:
        sys.exit(f"{path}: no '{marker}' line")
    return ast.literal_eval(found[-1])


def steps_of(log: str):
    meta = os.path.join(os.path.splitext(log)[0], "ckpt", "meta.json")
    if not os.path.isfile(meta):
        return None
    with open(meta) as f:
        return json.load(f).get("iter")


def stage_table(run: str) -> dict:
    """``<run>/stages.txt``: a line ``name exit_code t0 t1`` a stage."""
    out = {}
    path = os.path.join(run, "stages.txt")
    if os.path.isfile(path):
        with open(path) as f:
            for line in f:
                name, rc, t0, t1 = line.split()
                try:
                    seconds = float(t1) - float(t0)
                except ValueError:  # a date(1) without %N
                    seconds = None
                out[name] = {"exit_code": int(rc), "seconds": seconds}
    return out


def pair(text: str):
    name, _, log = text.partition("=")
    return name, log


def main(argv=None) -> int:
    p = argparse.ArgumentParser("ab_verdict_torch")
    p.add_argument("--gate", required=True)
    p.add_argument("--run", required=True)
    p.add_argument("--baseline", required=True, type=pair)
    p.add_argument("--gated", action="append", default=[], type=pair)
    p.add_argument("--reported", action="append", default=[], type=pair)
    p.add_argument("--eval", default=None)
    args = p.parse_args(argv)

    arms, ok = {}, True
    roles = ([(args.baseline, "baseline")] + [(a, "gated") for a in args.gated]
             + [(a, "reported") for a in args.reported])
    for (name, log), role in roles:
        acc = last_dict(log, "final eval:")
        print(f"{name}: final eval: {acc}", flush=True)
        arms[name] = {"role": role, "top1": acc[1], "top5": acc.get(5), "steps": steps_of(log)}
    base = arms[args.baseline[0]]
    base["floor"] = FLOOR
    base["verdict"] = "PASS" if base["top1"] >= FLOOR else "FAIL"
    ok &= base["verdict"] == "PASS"
    for name, arm in arms.items():
        if arm["role"] == "baseline":
            continue
        arm["gap"] = arm["top1"] - base["top1"]
        if arm["role"] == "gated":
            arm["verdict"] = "PASS" if abs(arm["gap"]) <= GAP else "FAIL"
            ok &= arm["verdict"] == "PASS"
        else:
            arm["verdict"] = "reported"
    result = {"gate": args.gate, "baseline": args.baseline[0],
              "rule": f"|top-1 - baseline| <= {GAP} for gated arms; baseline top-1 >= {FLOOR}",
              "arms": arms}
    if args.eval:
        ev = last_dict(args.eval, "eval result:")
        n = ev["n"]
        counts = {k: round(v * n) for k, v in ev["acc"].items()}
        want = {k: round(base[key] * n) for k, key in ((1, "top1"), (5, "top5"))}
        equal = ev["acc"][1] == base["top1"] and ev["acc"].get(5) == base["top5"]
        result["eval_worker"] = {"of": args.baseline[0], "n": n, "counts": counts,
                                 "final_eval_counts": want, "equal": equal,
                                 "verdict": "PASS" if equal else "FAIL"}
        ok &= equal
    result["stages"] = stage_table(args.run)
    result["pass"] = bool(ok)
    print(json.dumps(result), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
