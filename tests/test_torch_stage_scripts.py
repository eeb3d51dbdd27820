"""The port's staged runs on the CPU at a toy size: ``tools/parity_run_torch.sh
dry`` (through ``scripts/torch/*.sh``) and the two accuracy gates,
``tools/ab_graph_precision_torch.sh`` then ``tools/ab_atlas_moments_torch.sh``
on its artifacts, with ``AB_DEVICE=cpu``, small ``AB_*`` knobs and
``AB_EXTRA`` sizes (64 synthetic images of 32^2, patches of 8, K 4, M 16).
Every stage's exit code and artifact, the arms' ``final eval`` lines and the
JSON line are checked, and ``eval_worker``'s counts against stage 4's final
eval; no accuracy is asserted at this size. Then the verdict's rules
(``tools/ab_verdict_torch.py``) on hand-written logs.

Each subprocess has a time limit of its own; they run with 2 threads a
process and without TensorBoard (a package on ``PYTHONPATH`` that refuses
its import, so the writer does nothing: importing it costs ~20 s a process
here)."""

import ast
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
TOY = ("-o dataset.num_samples=64 -o dataset.image_size=32 -o dataset.resize=32 "
       "-o model.patch_embed.img_size=32 -o model.patch_embed.patch_size=8 "
       "-o schema_net.ir_atlas.feat_h=4 -o schema_net.ir_atlas.feat_w=4 "
       "-o training.num_workers=1 -o validation.num_workers=1 -o training.batch_size=16 "
       "-o validation.batch_size=32")
TIMEOUT_S = 240


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    hidden = tmp_path_factory.mktemp("no_tensorboard")
    (hidden / "tensorboard").mkdir()
    (hidden / "tensorboard" / "__init__.py").write_text(
        'raise ImportError("TensorBoard is hidden in this run")\n')
    return dict(os.environ, PYTHONPATH=str(hidden), OMP_NUM_THREADS="2", PYTHON=sys.executable)


def _run(argv, env, **extra):
    proc = subprocess.run(argv, cwd=REPO, env=dict(env, **extra), capture_output=True, text=True,
                          timeout=TIMEOUT_S)
    return proc, proc.stdout + proc.stderr


def _final_evals(text: str) -> list:
    return [ast.literal_eval(m) for m in re.findall(r"cli INFO: final eval: (\{.*\})", text)]


def _verdict(stdout: str) -> dict:
    lines = [line for line in stdout.splitlines() if line.startswith('{"gate"')]
    assert len(lines) == 1, stdout[-3000:]
    return json.loads(lines[0])


def test_parity_kit_dry(tmp_path, env):
    run = tmp_path / "run"
    proc, out = _run(["sh", "tools/parity_run_torch.sh", "dry", *TOY.split(),
                      "-o", "training.batch_size=32", "-o", "dataset.num_samples=128"],
                     env, RUN_DIR=str(run))
    assert proc.returncode == 0, out[-4000:]
    for n in range(6):
        assert f"] stage {n}:" in out, n
    assert "DONE" in out and "FAIL" not in out
    s = run / "synthetic"
    for artifact in ("vanilla/deit_tiny/ckpt/best.pt",
                     "ingredient/deit_tiny-l9-M_128/cluster_128_from_2048.npy",
                     "ingredient/deit_tiny-l9-M_128/cluster_128_from_2048.pth",
                     "ingredient/deit_tiny-l9-M_128/bundle/manifest.json",
                     "schema_net/init_IR_atlas-deit_tiny-l9-M_128.pt",
                     "schema_net/deit_tiny-l9-M_128/ckpt/best.pt",
                     "eval/deit_tiny-l9-M_128/logs/exp.log"):
        assert (s / artifact).exists(), artifact
    finals = _final_evals(out)
    assert len(finals) == 2 and all(set(f) == {1, 5} for f in finals)  # stages 0 and 4
    ev = ast.literal_eval(re.findall(r"eval result: (\{.*\})", out)[-1])
    assert ev["n"] == 128 and set(ev["acc"]) == {1, 5} and "cb" in ev


@pytest.fixture(scope="module")
def gp_gate(tmp_path_factory, env):
    run = tmp_path_factory.mktemp("ab") / "run"
    knobs = dict(AB_RUN=str(run), AB_K="4", AB_M="16", AB_MAXF="512", AB_EPOCHS="2",
                 AB_BS="16", AB_DEVICE="cpu", AB_EXTRA=TOY)
    proc, out = _run(["sh", "tools/ab_graph_precision_torch.sh"], env, **knobs)
    return run, knobs, proc, out


def _check_verdict(proc, verdict, arms):
    assert proc.returncode == (0 if verdict["pass"] else 1)
    assert set(verdict["arms"]) == set(arms)
    for name, role in arms.items():
        arm = verdict["arms"][name]
        assert arm["role"] == role and arm["steps"] == 8  # 2 epochs of 4 steps of 16
        assert 0.0 <= arm["top1"] <= arm["top5"] <= 1.0
        if role != "baseline":
            assert arm["gap"] == arm["top1"] - verdict["arms"][verdict["baseline"]]["top1"]
            assert arm["verdict"] == ("reported" if role == "reported" else
                                      "PASS" if abs(arm["gap"]) <= 0.005 else "FAIL")


def test_graph_precision_gate_mechanics(gp_gate):
    run, _, proc, out = gp_gate
    assert proc.returncode in (0, 1), out[-4000:]
    verdict = _verdict(proc.stdout)
    stages = ("vanilla", "extract", "export", "init", "schema_default", "schema_highest",
              "eval_default")
    assert list(verdict["stages"]) == list(stages)
    assert all(s["exit_code"] == 0 and s["seconds"] > 0 for s in verdict["stages"].values())
    for artifact in ("vanilla/ckpt/best.pt", "ingredient/cluster_16_from_512.npy",
                     "ingredient/bundle/manifest.json", "init_IR_atlas.pt",
                     "schema_default/ckpt/best.pt", "schema_highest/ckpt/best.pt"):
        assert (run / artifact).exists(), artifact
    _check_verdict(proc, verdict, {"default": "baseline", "highest": "gated"})
    for arm in ("default", "highest"):  # the arm's line, as the JAX gate prints it
        want = _final_evals((run / f"schema_{arm}.stdout").read_text())[-1]
        assert f"{arm}: final eval: {want}" in proc.stdout
        assert verdict["arms"][arm]["top1"] == want[1] and verdict["arms"][arm]["top5"] == want[5]
    # eval_worker on the default arm's best checkpoint: its counts are the final eval's
    ev = verdict["eval_worker"]
    final = _final_evals((run / "schema_default.stdout").read_text())[-1]
    assert ev["n"] == 64 and ev["equal"] and ev["verdict"] == "PASS"
    assert ev["counts"] == {str(k): round(v * 64) for k, v in final.items()}
    assert ev["counts"] == ev["final_eval_counts"]


def test_atlas_moments_gate_mechanics(gp_gate, env):
    run, knobs, first, _ = gp_gate
    assert first.returncode in (0, 1)
    proc, out = _run(["sh", "tools/ab_atlas_moments_torch.sh"], env, **knobs)
    assert proc.returncode in (0, 1), out[-4000:]
    verdict = _verdict(proc.stdout)
    assert [k for k in verdict["stages"] if k.startswith("schema_mom")] == [
        "schema_mom_bf16", "schema_mom_factored"]
    assert all(s["exit_code"] == 0 for s in verdict["stages"].values())
    for arm in ("bf16", "factored"):
        assert (run / f"schema_mom_{arm}" / "ckpt" / "best.pt").exists()
        want = _final_evals((run / f"schema_mom_{arm}.stdout").read_text())[-1]
        assert f"{arm}: final eval: {want}" in proc.stdout
    _check_verdict(proc, verdict, {"fp32": "baseline", "bf16": "gated", "factored": "reported"})
    assert "eval_worker" not in verdict


def _log(path, line):
    path.write_text(f"2026-01-01 00:00:00,000 [p0] cli INFO: {line}\n")
    return str(path)


@pytest.mark.parametrize("base, other, eval_acc, want_pass, why", [
    (0.50, 0.504, 0.50, True, "within 0.5 pt"),
    (0.50, 0.494, 0.50, False, "a gated arm 0.6 pt away"),
    (0.09, 0.09, 0.09, False, "the baseline under the floor"),
    (0.50, 0.50, 0.25, False, "eval_worker apart from the final eval"),
])
def test_verdict_rules(tmp_path, base, other, eval_acc, want_pass, why):
    argv = [sys.executable, "tools/ab_verdict_torch.py", "--gate", "g", "--run", str(tmp_path),
            "--baseline", "a=" + _log(tmp_path / "a.stdout", f"final eval: {{1: {base}, 5: 0.9}}"),
            "--gated", "b=" + _log(tmp_path / "b.stdout", f"final eval: {{1: {other}, 5: 0.9}}"),
            "--reported", "c=" + _log(tmp_path / "c.stdout", "final eval: {1: 0.0, 5: 0.1}"),
            "--eval", _log(tmp_path / "e.stdout",
                           f"eval result: {{'loss': 1.0, 'acc': {{1: {eval_acc}, 5: 0.9}}, "
                           f"'n': 200}}")]
    proc = subprocess.run(argv, cwd=REPO, capture_output=True, text=True, timeout=60)
    verdict = json.loads(proc.stdout.splitlines()[-1])
    assert verdict["pass"] is want_pass, why
    assert proc.returncode == (0 if want_pass else 1)
    assert verdict["arms"]["c"]["verdict"] == "reported"
    assert proc.stdout.splitlines()[0] == f"a: final eval: {{1: {base}, 5: 0.9}}"
