"""The benchmark of peng_motif_tpu_torch: whole motif-discovery jobs,
each one in-process call of the port's CLI, back to back on one card.

    python3 -m bench_port.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  Everything a cell needs is found by name:
the cell in ``BENCHMARK.json``, its configuration's file (the corpus's
generator in ``bench_port/corpora/``, the deployment's settings), its
traffic in ``bench_port/traffic/<traffic>.json`` (the job's flags, what
set-up does, the engine path every job must take), each metric's reader
in ``bench_port/metrics/<metric>.py`` and the cell's limits in
``bench_port/limits/<cell>.json``.

A run: the CUDA context; the corpus, made from the seed and written
once; the traffic's set-up (a checkpoint) and its warm-up jobs, the
first of which builds the port's libraries in the checkout (the jobs
before the window are kept, and the process's age taken between the
steps, for the set-up's split); then jobs
one after another for ``--seconds`` (a closed loop), each one timed on
the host clock.  With ``--trace 1`` a few more whole jobs run under
torch.profiler.  After that, with the program's state freed, the plain
reference (``bench_port/reference/``) works out the count layer and the
motifs again and every job's output is held against it.  The last line
of stdout is one JSON object; the numbers compared, each beside its
limit, are the last lines of stderr.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import io
import json
import os
import statistics
import sys
import tempfile
import time

START = time.time()

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "peng_motif_tpu")


def process_age() -> float:
    """Seconds since this process started (Linux), else since import."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time() - START


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``peng_motif_tpu_torch`` is not ``peng_motif_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names
                   if m.split(".")[0] in FORBIDDEN})


# -- finding a cell's files ---------------------------------------------------


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path):
    """A module of the benchmark by file path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "bench_port_" + os.path.basename(path)[:-3].replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, root: str = ROOT) -> dict:
    """Everything the cell ``name`` of ``root/BENCHMARK.json`` uses."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    here = os.path.join(root, "bench_port")
    config = load_json(os.path.join(root, conf["file"]))
    traffic = load_json(os.path.join(here, "traffic",
                                     cell["traffic"] + ".json"))
    limits = load_json(os.path.join(here, "limits", name + ".json"))

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    return dict(name=name, cell=cell, config=config, traffic=traffic,
                limits=limits, root=root,
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)])


def reader(root: str, metric: str):
    return load_module(os.path.join(root, "bench_port", "metrics",
                                    metric + ".py")).read


# -- one job --------------------------------------------------------------------


class _Stderr:
    """A stream that writes to whatever ``sys.stderr`` is now, so the
    program's logger, made once, follows each job's redirection."""

    def write(self, s):
        return sys.stderr.write(s)

    def flush(self):
        sys.stderr.flush()


def job_argv(traffic: dict, i: int, fasta: str, out: str, device: str,
             checkpoint: str = None) -> list:
    """The i-th job's flags: the traffic's, the i-th value of each cycled
    flag, ``--timing`` (its phases are read; the phases are timed with or
    without it) and ``--device``."""
    argv = [fasta] + list(traffic["argv"])
    for flag, values in traffic.get("cycle", {}).items():
        argv += [flag, values[i % len(values)]]
    if checkpoint:
        argv += ["--load-checkpoint", checkpoint]
    return argv + ["-o", out, "--timing", "--device", device.split(":")[0]]


def run_job(main, engine, argv: list, expect: dict, device: str) -> dict:
    """One in-process CLI call, its output in memory."""
    out, err = io.StringIO(), io.StringIO()
    exc = None
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(argv)
    except SystemExit as e:              # the CLI exits on bad flags
        rc = e.code if isinstance(e.code, int) else 1
    except Exception as e:               # noqa: BLE001 - a failed job is counted
        rc, exc = 1, f"{type(e).__name__}: {e}"
    wall = time.perf_counter() - t0
    phases = {}
    for line in err.getvalue().splitlines():
        if line.startswith("[TIMING] "):
            name, ms = line[9:].rsplit(": ", 1)
            phases[name] = float(ms.split()[0]) / 1e3
    marks = dict(engine=engine.LAST_ENGINE_USED,
                 climb=engine.LAST_CLIMB_ENGINE, pwm=engine.LAST_PWM_ENGINE,
                 hybrid_frac=engine.LAST_HYBRID_FRAC)
    want = dict(expect)
    if want.get("engine") == "device":
        want["engine"] = "gpu" if device.startswith("cuda") else "cpu"
    off_path = {k: marks[k] for k in want if marks.get(k) != want[k]}
    return dict(wall=wall, rc=rc, exc=exc, phases=phases, marks=marks,
                off_path=off_path, stdout=out.getvalue(),
                stderr=err.getvalue()[-2000:])


class Capture:
    """Keeps, for each job, what the program's count phase returned: the
    mirrored table, ltot and the background counts it delivered."""

    def __init__(self, engine):
        self.engine, self.real = engine, engine._count_phase
        self.last = None

    def __enter__(self):
        def count_phase(peng, *a, **k):
            out = self.real(peng, *a, **k)
            self.last = (out[0], out[1], [n for n in peng.bg_model.n])
            return out
        self.engine._count_phase = count_phase
        return self

    def __exit__(self, *exc):
        self.engine._count_phase = self.real

    def take(self):
        got, self.last = self.last, None
        return got


def window_summary(jobs) -> str:
    """One line on the window's jobs: walls and each phase's median."""
    def med(xs):
        xs = sorted(xs)
        return xs[len(xs) // 2] if xs else float("nan")
    walls = [j["wall"] for j in jobs]
    phases = {p: med([j["phases"].get(p, 0.0) for j in jobs])
              for p in ("count", "optimize", "pwm", "em+merge")}
    return (f"window: {len(jobs)} jobs, wall min {min(walls):.4f} median "
            f"{med(walls):.4f} max {max(walls):.4f} s; phase medians "
            + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in phases.items())
            + " ms")


def setup_summary(marks, context_s, warmup, jobs, n=40) -> str:
    """One line on the set-up: the process ages at its marks, the
    harness's CUDA context, and the process's first job against the
    window's: its wall, and the span paths that took at least 1 ms longer
    than their median over the window's jobs, the longest first (a path
    no window job has counts 0 there; ``setup.import`` lies before the
    job and is given apart)."""
    line = ("set-up marks (s from process start): "
            + ", ".join(f"{k} {v:.2f}" for k, v in marks.items())
            + f"; context {context_s * 1e3:.1f} ms")
    if not warmup or not jobs:
        return line
    first = warmup[0]["phases"]
    med = {p: statistics.median([j["phases"].get(p, 0.0) for j in jobs])
           for p in first}
    cold = sorted(((first[p] - med[p], p) for p in first
                   if p != "setup.import" and first[p] - med[p] >= 1e-3),
                  reverse=True)[:n]
    return (line + f"; first job wall {warmup[0]['wall'] * 1e3:.1f} ms "
            f"(window median "
            f"{statistics.median(j['wall'] for j in jobs) * 1e3:.1f}), "
            f"setup.import {first.get('setup.import', float('nan')) * 1e3:.1f}"
            " ms; first job less window median (ms): "
            + ", ".join(f"{p} {d * 1e3:+.1f}" for d, p in cold))


def card_limits() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess

    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        return p.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not read"


# -- the run --------------------------------------------------------------------


def run(cell: dict, seed: int, seconds: float, trace: bool, device: str,
        workdir: str, hooks=None, control: bool = False,
        record: dict = None, marks: dict = None) -> dict:
    """One run of ``cell`` in ``workdir``; returns the result line's
    object.  ``hooks`` (tests): a context manager entered around the
    window, for planting a fault under the timed path.  ``control``
    (``bench_port.control``): also the control's readings, under
    ``"control"``, and whether they pass the same limits, under
    ``"control_correct"``.  ``record`` (tests): a dict the run's record,
    which the readers read, is copied into.  ``marks``: the process's
    ages at the steps before the run (:func:`main`'s), which the run's
    own marks follow."""
    import torch

    from peng_motif_tpu_torch import engine
    from peng_motif_tpu_torch.cli import main
    from peng_motif_tpu_torch.ops import histogram
    from peng_motif_tpu_torch.utils import logging_utils

    from . import checks

    marks = dict(marks or {}, imports=process_age())
    log = lambda *a: print(*a, file=sys.stderr, flush=True)  # noqa: E731
    on_card = device.startswith("cuda")
    t0 = time.perf_counter()
    if on_card:
        torch.zeros(1, device=device)
        torch.cuda.synchronize()
    context_s = time.perf_counter() - t0
    marks["context"] = process_age()
    if on_card:
        log(f"card: {card_limits()}")
    marks["card"] = process_age()
    logging_utils.get_logger().handlers[0].setStream(_Stderr())
    config, traffic = cell["config"], cell["traffic"]
    root = cell["root"]

    t0 = time.perf_counter()
    fasta = os.path.join(workdir, "corpus.fasta")
    gen = load_module(os.path.join(root, "bench_port", "corpora",
                                   config["generator"] + ".py"))
    bases = gen.write(fasta, config["params"], seed, root)
    log(f"corpus: {config['generator']}, {bases} bases, seed {seed}, "
        f"made in {time.perf_counter() - t0:.3f} s")

    expect = traffic["expect"]
    checkpoint = None
    warmup = []             # the jobs before the window, in the order run
    if traffic.get("checkpoint"):
        checkpoint = os.path.join(workdir, "checkpoint")
        argv = job_argv({"argv": traffic["argv"]}, 0, fasta,
                        os.path.join(workdir, "setup.meme"), device)
        job = run_job(main, engine, argv + ["--save-checkpoint", checkpoint],
                      {}, device)
        if job["rc"] != 0:
            raise RuntimeError(f"set-up job failed: {job['exc']} "
                               f"{job['stderr']}")
        warmup.append(job)
    marks["corpus"] = process_age()
    capture = Capture(engine)

    def one(i, name):
        out = os.path.join(workdir, f"{name}{i}.meme")
        argv = job_argv(traffic, i, fasta, out, device, checkpoint)
        job = run_job(main, engine, argv, expect, device)
        job.update(out=out, count=capture.take(), argv=argv)
        return job

    with capture:
        for i in range(traffic.get("warmup_jobs", 2)):
            job = one(i, "warm")
            if job["rc"] != 0:
                raise RuntimeError(f"warm-up job failed: {job['exc']} "
                                   f"{job['stderr']}")
            # kept without its table, which the check does not read
            warmup.append({k: v for k, v in job.items() if k != "count"})
            if i == 0:
                marks["first_warmup"] = process_age()
        if on_card:
            torch.cuda.synchronize()
        setup_s = process_age()
        log(f"set-up: {setup_s:.3f} s from process start")

        # the window: jobs back to back until the time is up
        jobs = []
        launches0 = histogram.LAUNCHES
        with (hooks() if hooks else contextlib.nullcontext()):
            start = time.perf_counter()
            deadline = start + seconds
            while not jobs or time.perf_counter() < deadline:
                jobs.append(one(len(jobs), "job"))
            window_s = time.perf_counter() - start
            launches = histogram.LAUNCHES - launches0
            log(window_summary(jobs))
            log(setup_summary(marks, context_s, warmup, jobs))
            traced = None
            if trace:
                from . import tracing

                n_variants = max([len(v) for v in
                                  traffic.get("cycle", {}).values()] + [1])
                traced = tracing.traced_jobs(
                    lambda k: one(len(jobs) + k, "traced"),
                    max(3, n_variants), workdir, device)
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    log(f"device memory peak (max_memory_allocated): {memory_peak} bytes")
    failed = sum(1 for j in jobs if j["rc"] != 0 or j["off_path"])
    for j in jobs:
        if j["rc"] != 0 or j["off_path"]:
            log(f"job failed: rc {j['rc']} {j['exc'] or ''} off path "
                f"{j['off_path']} {j['stderr'][-300:]}")
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    rec = dict(jobs=jobs, window_s=window_s, setup_s=setup_s,
               launches=launches, trace=traced, device_kind=kind,
               warmup=warmup, setup_marks=marks, context_s=context_s)
    if record is not None:
        record.update(rec)
    t0 = time.perf_counter()
    checked_jobs = jobs + (traced["jobs"] if traced else [])
    numbers = checks.check(cell, fasta, checked_jobs, checkpoint, device,
                           control)
    low = {k: numbers.pop(k) for k in list(numbers)
           if k.startswith("control.")}
    log(f"reference and comparison: {time.perf_counter() - t0:.3f} s")
    limits = cell["limits"]
    checked = {k: [v, limits[k]] for k, v in numbers.items()}
    correct = (bool(jobs) and all(j["rc"] == 0 for j in checked_jobs)
               and checks.judge(numbers, limits))

    section = cell["per_layer"] if trace else cell["end_to_end"]
    metrics = {}
    for m in section:
        value = reader(root, m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = dict(correct=correct, attempted=len(jobs), failed=failed,
                  metrics=metrics, device=dict(
                      platform="gpu" if on_card else "cpu",
                      kind=kind,
                      count=1, memory_peak_bytes=memory_peak))
    if traced:
        result["device"].update(busy_s=traced["busy_s"],
                                window_s=traced["window_s"])
        result["breakdown"] = traced["breakdown"]
    if control:
        result["control"] = {k[len("control."):]: v for k, v in low.items()}
        result["control_correct"] = checks.judge(result["control"], limits)
    result["checked"] = checked
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    marks = {"main": process_age()}

    cell = load_cell(args.workload)
    import torch

    marks["torch"] = process_age()
    chips = cell["cell"].get("chips", 1)
    found = torch.cuda.is_available() and torch.cuda.device_count()
    marks["cuda_check"] = process_age()
    if found < chips:
        print(f"error: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    try:
        import peng_motif_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"error: the program is not in this checkout: {e}",
              file=sys.stderr)
        return 2
    marks["program"] = process_age()
    tmp = tempfile.mkdtemp(prefix="bench_port_",
                           dir=os.environ.get("TMPDIR"))
    try:
        result = run(cell, args.seed, args.seconds, bool(args.trace),
                     "cuda:0", tmp, marks=marks)
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    found = forbidden_modules()
    if found:
        print(f"error: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)     # "checked" is its last key
    for k, (v, lim) in result["checked"].items():
        print(f"{k} {v} limit {lim}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
