"""Whole runs on the CPU at a test size: the harness drives the port's
CLI, reads its markers and counters, and holds every job against the
reference; with the timed path broken underneath, ``correct`` comes out
false.  The card's own run is marked ``gpu`` and skips without a card."""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from bench_port import run as R

ROOT = R.ROOT
TINY = {"name": "tiny", "source": "test", "generator": "planted_peaks",
        "params": {"n_seq": 240, "length": 200, "rate": 0.3,
                   "sites": ["TGAGTCAC", "TGACTCAC"]},
        "reduced": []}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout's benchmark with two test cells on the CPU: the real
    cells' settings and limits, a small corpus, -w 8 on the device
    engine (on the CPU, auto would take the exact engine)."""
    root = tmp_path_factory.mktemp("root")
    shutil.copytree(os.path.join(ROOT, "bench_port"), root / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "bench_port/configs/mafk_1m.json")) as f:
        tiny = dict(TINY, settings=json.load(f)["settings"])
    (root / "bench_port/configs/tiny.json").write_text(json.dumps(tiny))
    expect = {"engine": "device", "climb": "device", "pwm": "device"}
    for name, extra in (("cpu_w8", {}), ("cpu_resume_w8", {
            "cycle": {"-t": ["8", "12", "10"]}, "checkpoint": True,
            "warmup_jobs": 3})):
        (root / f"bench_port/traffic/{name}.json").write_text(json.dumps(
            dict({"argv": ["-w", "8", "--engine", "tpu"], "expect": expect},
                 **extra)))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"].append({"name": "tiny", "source": "test", "reduced": [],
                         "file": "bench_port/configs/tiny.json", "why": "t"})
    with open(os.path.join(ROOT, "bench_port/limits/mafk_w10.json")) as f:
        limits = json.load(f)
    for cell, traffic, extra in (("tiny_w8", "cpu_w8", {}),
                                 ("tiny_w8.resume", "cpu_resume_w8",
                                  {"bg_mismatch": 0})):
        b["workloads"].append({"name": cell, "config": "tiny", "chips": 1,
                               "traffic": traffic, "why": "t"})
        (root / f"bench_port/limits/{cell}.json").write_text(
            json.dumps(dict(limits, **extra)))
        for m in b["end_to_end"] + b["per_layer"]:
            if "mafk_w10" in m.get("workloads", ()):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return str(root)


def run(root, cell, tmp_path, seconds=2.5, trace=False, hooks=None,
        control=False):
    return R.run(R.load_cell(cell, root), 2 ** 33 + 5, seconds, trace, "cpu",
                 str(tmp_path), hooks=hooks, control=control)


def test_a_run_is_correct(root, tmp_path):
    res = run(root, "tiny_w8", tmp_path)
    # a slow machine may finish one job in the window, never none
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"job_s", "job_p90_s", "setup_s"}
    assert all(v[0] <= v[1] for v in res["checked"].values())
    assert list(res)[-1] == "checked"
    assert res["device"]["platform"] == "cpu"


def test_a_traced_run_reads_the_layers(root, tmp_path):
    res = run(root, "tiny_w8", tmp_path, trace=True)
    assert res["correct"]
    m = res["metrics"]
    assert {"count_ms", "optimize_ms", "pwm_ms", "merge_ms", "cli_other_ms",
            "device_idle_pct"} <= set(m)
    assert "job_s" not in m
    # on the CPU no kernel is launched: no roofline share at all
    assert "hist_roofline_pct" not in m
    assert res["device"]["window_s"] > 0
    assert res["breakdown"]["idle_gaps"]


SETUP_PARTS = ("setup_import_ms", "setup_context_ms", "setup_first_job_ms",
               "setup_harness_ms")


def test_a_run_keeps_its_set_up(root, tmp_path, monkeypatch):
    """The jobs before the window are kept, the process's age rises from
    mark to mark up to setup_s, and the set-up's parts, read from the
    run's first job as from a fresh process's, sum to setup_s."""
    from peng_motif_tpu_torch.utils import logging_utils

    if logging_utils.process_start_ns() is None:
        pytest.skip("no process start to read off Linux")
    monkeypatch.setattr(logging_utils, "_COLD", True)
    rec = {}
    res = R.run(R.load_cell("tiny_w8", root), 2 ** 33 + 7, 1.0, True, "cpu",
                str(tmp_path), record=rec)
    assert res["correct"]
    assert len(rec["warmup"]) == 2
    assert all(j["rc"] == 0 and "count" not in j for j in rec["warmup"])
    assert "setup.import" in rec["warmup"][0]["phases"]
    assert "setup.import" not in rec["warmup"][1]["phases"]
    marks = rec["setup_marks"]
    assert list(marks) == ["imports", "context", "card", "corpus",
                           "first_warmup"]
    ages = list(marks.values())
    assert ages == sorted(ages) and ages[-1] <= rec["setup_s"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(SETUP_PARTS) | {"setup_cold_ms"} <= set(m)
    assert sum(m[k] for k in SETUP_PARTS) == pytest.approx(
        rec["setup_s"] * 1e3, abs=1e-6)
    assert m["setup_harness_ms"] >= 0
    assert m["setup_first_job_ms"] == pytest.approx(
        rec["warmup"][0]["wall"] * 1e3)


def test_a_resumed_run_keeps_its_set_up_job_first(root, tmp_path):
    rec = {}
    run_rec = R.run(R.load_cell("tiny_w8.resume", root), 2 ** 33 + 9, 0.5,
                    False, "cpu", str(tmp_path), record=rec)
    assert run_rec["correct"]
    # the checkpoint's set-up job, then the traffic's three warm-up jobs
    assert len(rec["warmup"]) == 4
    assert "--save-checkpoint" not in rec["warmup"][1]["argv"]
    ages = list(rec["setup_marks"].values())
    assert ages == sorted(ages) and ages[-1] <= rec["setup_s"]


def test_a_resumed_run_checks_the_checkpoint(root, tmp_path):
    res = run(root, "tiny_w8.resume", tmp_path)
    assert res["correct"], res["checked"]
    assert res["checked"]["bg_mismatch"] == [0, 0]


@contextlib.contextmanager
def patched(obj, name, make):
    real = getattr(obj, name)
    setattr(obj, name, make(real))
    try:
        yield
    finally:
        setattr(obj, name, real)


def test_a_count_altered_where_it_is_made_is_caught(root, tmp_path):
    from peng_motif_tpu_torch import engine

    def make(real):
        def mirror(vals, W, both):
            out = real(vals, W, both)
            out[int(np.argmax(out))] += 1
            return out
        return mirror

    res = run(root, "tiny_w8", tmp_path,
              hooks=lambda: patched(engine, "_mirror_host", make))
    assert not res["correct"]
    assert res["checked"]["count_diff"][0] > 0


def test_a_motif_altered_where_it_is_made_is_caught(root, tmp_path):
    from peng_motif_tpu_torch import engine

    def make(real):
        def em(*a, **k):
            pwm, iters = real(*a, **k)
            pwm = pwm.clone()
            pwm[:, 0, 0] += 1e-3
            return pwm, iters
        return em

    res = run(root, "tiny_w8", tmp_path,
              hooks=lambda: patched(engine, "em_optimize_flat", make))
    assert not res["correct"]
    assert res["checked"]["pwm_err"][0] > res["checked"]["pwm_err"][1]


def test_a_wrong_seed_set_is_caught(root, tmp_path):
    """The top seed left out where the seeds are selected."""
    from peng_motif_tpu_torch import engine

    def make(real):
        def select(*a, **k):
            return real(*a, **k)[1:]
        return select

    res = run(root, "tiny_w8", tmp_path,
              hooks=lambda: patched(engine, "_select_seeds_host", make))
    assert not res["correct"]
    assert res["checked"]["seed_mismatch"][0] > 0


def test_a_truncated_climb_is_caught(root, tmp_path):
    """Every walk stopped after its first step, where the walks run."""
    from peng_motif_tpu_torch import engine

    def make(real):
        def walks(*a, **k):
            trace = real(*a, **k)
            improved = trace.improved.copy()
            improved[1:] = False
            return trace._replace(improved=improved)
        return walks

    res = run(root, "tiny_w8", tmp_path,
              hooks=lambda: patched(engine, "run_walks", make))
    assert not res["correct"]
    assert res["checked"]["climb_mismatch"][0] > 0


def test_the_seed_threshold_is_the_jobs_own(root, tmp_path):
    """Seeds selected at -t 10 whatever -t the job was given (the test's
    resumed traffic cycles -t 8, 12, 10: the window's first job, which
    every window has, takes -t 8)."""
    from peng_motif_tpu_torch import engine

    def make(real):
        def select(z, counts, W, zthr, *a, **k):
            return real(z, counts, W, 10.0, *a, **k)
        return select

    res = run(root, "tiny_w8.resume", tmp_path,
              hooks=lambda: patched(engine, "_select_seeds_host", make))
    assert not res["correct"]
    assert res["checked"]["seed_mismatch"][0] > 0


def test_a_failing_job_is_counted(root, tmp_path):
    from peng_motif_tpu_torch import engine

    def make(real):
        def em(*a, **k):
            raise RuntimeError("planted")
        return em

    res = run(root, "tiny_w8", tmp_path,
              hooks=lambda: patched(engine, "em_optimize_flat", make))
    assert not res["correct"]
    assert res["failed"] == res["attempted"]


def test_a_job_off_the_path_is_counted(root, tmp_path):
    """A climb overflow sends a job to the exact engine: its answer is
    right, but it measured another path."""
    from peng_motif_tpu_torch import engine

    def make(real):
        def walks(*a, **k):
            raise engine.ClimbOverflow("planted")
        return walks

    res = run(root, "tiny_w8", tmp_path,
              hooks=lambda: patched(engine, "run_walks", make))
    assert res["failed"] == res["attempted"] > 0


def test_the_control_fails(root, tmp_path):
    """The reference in the precision below the stated one, in the
    program's place, reads past a limit; the program does not."""
    res = run(root, "tiny_w8", tmp_path, control=True)
    assert res["correct"]
    assert not res["control_correct"]
    assert res["control"]["seed_mismatch"] == 0


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = R.main(["--workload", "mafk_w10", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


@pytest.mark.gpu
def test_a_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run(
        [sys.executable, "-m", "bench_port.run", "--workload", "mafk_w10",
         "--seed", str(2 ** 32 + 11), "--seconds", "3", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["failed"] == 0
    assert 0 < res["metrics"]["hist_roofline_pct"]["value"] <= 105
