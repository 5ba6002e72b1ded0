"""The port's span and counter recorder (utils/logging_utils.PhaseTimer)
on the CPU: span paths, parents and threads on whole MafK jobs through
the CLI, the ``--timing`` report as the benchmark reads it
(bench_port/run.py and the readers in bench_port/metrics/), the work
counts against what the climb and EM did, and the ``--profile`` trace.
The counters' agreement with the card's own account (sync-debug
warnings, the trace's host-to-device copies) is held on the card, in
tests/test_torch_gpu.py.
"""

import contextlib
import io
import json
import os
import threading

import numpy as np
import pytest
import torch

from conftest import GOLDEN_DIR

from bench_port import run as bench_run
from peng_motif_tpu_torch import cli, engine
from peng_motif_tpu_torch.ops import hybrid
from peng_motif_tpu_torch.utils import logging_utils as lu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAFK = os.path.join(GOLDEN_DIR, "MafK_100seqs.fasta")
TOP = ("parse", "background", "count", "optimize", "replay", "pwm",
       "em+merge", "redundancy", "output")
CHILDREN = ("count.stream", "count.enqueue", "count.bg_correct",
            "count.fetch", "count.fixup", "count.upload", "count.seeds",
            "count.seeds.fetch", "count.seeds.sort",
            "count.seeds.walk", "optimize.step", "optimize.fetch", "pwm.adv", "pwm.em_round",
            "pwm.fetch", "em+merge.merge")
READERS = ("parse_ms", "untraced_ms", "seed_select_ms", "replay_ms",
           "climb_step_ms", "climb_steps_per_job", "em_rounds_per_job",
           "redundancy_ms", "host_syncs_per_job", "h2d_copies_per_job",
           "h2d_mb_per_job", "climb_graph_steps_per_job", "seed_sort_ms",
           "seed_card_partitions_per_job", "em_kernel_rounds_per_job",
           "climb_kernel_steps_per_job", "climb_ids_per_job")


class _Kept(lu.PhaseTimer):
    """A recorder that the test can read after the job."""

    made: list = []

    def __init__(self):
        super().__init__()
        _Kept.made.append(self)


def _job(tmp_path, *extra, engine_flag="tpu"):
    """One MafK -w 8 job through cli.main: (stdout, stderr, MEME bytes,
    the job's recorder)."""
    _Kept.made.clear()
    out, err = io.StringIO(), io.StringIO()
    meme = tmp_path / f"o{len(os.listdir(tmp_path))}.meme"
    argv = [MAFK, "-w", "8", "--device", "cpu", "--engine", engine_flag,
            "-o", str(meme), *extra]
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert cli.main(argv) == 0
    (recorder,) = _Kept.made
    return out.getvalue(), err.getvalue(), meme.read_bytes(), recorder


@pytest.fixture
def kept(monkeypatch):
    monkeypatch.setattr(cli, "PhaseTimer", _Kept)


def test_span_paths_parents_and_disjoint_top_level(kept, tmp_path):
    _, _, _, rec = _job(tmp_path)
    home = threading.get_native_id()
    by_id = {s.id: s for s in rec.spans}
    top = sorted((s for s in rec.spans if s.parent == -1
                  and "." not in s.path), key=lambda s: s.start_ns)
    assert {s.thread for s in top} == {home}
    names = [s.path for s in top if s.path != "device"]
    assert names == list(TOP)
    for a, b in zip(top, top[1:]):
        assert a.end_ns <= b.start_ns, (a.path, b.path)
    paths = {s.path for s in rec.spans}
    assert set(CHILDREN) <= paths
    for s in rec.spans:
        assert s.start_ns <= s.end_ns
        if s.parent == -1:
            continue
        p = by_id[s.parent]
        assert s.path.startswith(p.path + ".")
        if s.thread == p.thread:
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_worker_thread_spans_have_the_span_that_started_them(
        kept, tmp_path, monkeypatch):
    """The lazy background scan of the exact engine runs on a thread: its
    span hangs under the span that started it, on its own thread.  The
    host count (forced here) runs on the main thread, under ``count``."""
    _, _, _, rec = _job(tmp_path, engine_flag="exact")
    (scan,) = [s for s in rec.spans if s.path == "background.bg_scan"]
    (bg,) = [s for s in rec.spans if s.path == "background"]
    assert scan.parent == bg.id and scan.thread != bg.thread
    assert bg.start_ns <= scan.start_ns <= scan.end_ns
    assert [s.path for s in rec.spans if s.path.endswith(".bg_wait")]
    monkeypatch.setattr(hybrid, "count_on_host", lambda *a: True)
    _, _, _, rec = _job(tmp_path)
    (host,) = [s for s in rec.spans if s.path == "count.host"]
    (count,) = [s for s in rec.spans if s.path == "count"]
    assert host.parent == count.id and host.thread == count.thread
    assert count.start_ns <= host.start_ns <= host.end_ns <= count.end_ns
    # the host count's two parts, inside it
    for name in ("scan", "mirror"):
        (part,) = [s for s in rec.spans if s.path == f"count.host.{name}"]
        assert part.parent == host.id and part.thread == host.thread
        assert host.start_ns <= part.start_ns <= part.end_ns <= host.end_ns
    assert not [s for s in rec.spans if s.thread != count.thread]


def test_every_timing_line_parses_and_every_reader_reads(tmp_path):
    argv = [MAFK, "-w", "8", "--device", "cpu", "--engine", "tpu", "-o",
            str(tmp_path / "o.meme"), "--timing"]
    job = bench_run.run_job(cli.main, engine, argv, {}, "cpu")
    assert job["rc"] == 0
    lines = [ln for ln in job["stderr"].splitlines()
             if ln.startswith("[TIMING] ")]
    assert len(job["phases"]) == len(lines) >= len(TOP) + len(CHILDREN)
    for name in ("count", "optimize", "pwm", "em+merge"):
        assert job["phases"][name] > 0
    rec = {"jobs": [job]}
    for metric in READERS:
        value = bench_run.reader(REPO, metric)(rec)
        assert isinstance(value, float) and value >= 0, metric
    # a job of a program without the recorder reads None, and no reader
    # raises on it
    bare = dict(job, stderr="[TIMING] count: 1.0 ms\n",
                phases={"count": 0.001})
    for metric in READERS:
        assert bench_run.reader(REPO, metric)({"jobs": [bare]}) is None


@pytest.mark.parametrize("engine_flag", ["tpu", "exact"])
def test_report_is_the_last_output_and_short(engine_flag, tmp_path):
    err = io.StringIO()
    argv = [MAFK, "-w", "8", "--device", "cpu", "--engine", engine_flag,
            "-o", str(tmp_path / "o.meme"), "--timing"]
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        assert cli.main(argv) == 0
    text = err.getvalue()
    start = text.index("[TIMING] ")
    report = text[start:]
    assert len(report) <= 1500
    lines = report.splitlines()
    assert all(ln.startswith(("[TIMING] ", "[COUNT] ")) for ln in lines)
    kinds = [ln.split()[0] for ln in lines]
    assert kinds == sorted(kinds, key=lambda k: k != "[TIMING]")
    # the device engine's seeds, climb and EM add their counters (the
    # seeds' 0 where the host sorts the whole table, the climb's and EM's
    # 0 off CUDA)
    device = (["[COUNT] seeds.card_partitions", "[COUNT] climb.graph_steps",
               "[COUNT] climb.kernel_steps", "[COUNT] climb.ids",
               "[COUNT] em.kernel_rounds"] if engine_flag == "tpu" else [])
    assert [ln.split(":")[0] for ln in lines if ln.startswith("[COUNT]")] \
        == ["[COUNT] syncs", "[COUNT] h2d.copies", "[COUNT] h2d.bytes"] \
        + device
    for ln in lines:
        if ln.startswith("[TIMING] "):
            path, rest = ln[9:].rsplit(": ", 1)
            assert ": " not in path
            ms, unit, calls = rest.split()
            assert float(ms) >= 0 and unit == "ms" and int(calls[1:-1]) >= 1


def test_climb_steps_are_the_walks_steps(kept, tmp_path, monkeypatch):
    traces = []
    real = engine.run_walks

    def run_walks(*a, **k):
        traces.append(real(*a, **k))
        return traces[-1]

    monkeypatch.setattr(engine, "run_walks", run_walks)
    _, _, _, rec = _job(tmp_path)
    (trace,) = traces
    assert trace.n_steps > 0
    assert rec.calls("optimize.step") == trace.n_steps


def test_em_rounds_are_the_em_loops_rounds(kept, tmp_path, monkeypatch):
    iters = []
    real = engine.em_optimize_flat

    def em_optimize_flat(*a, **k):
        out = real(*a, **k)
        iters.append(out[1])
        return out

    monkeypatch.setattr(engine, "em_optimize_flat", em_optimize_flat)
    _, _, _, rec = _job(tmp_path)
    (it,) = iters
    # the still-active motifs iterate together: the rounds are the
    # longest motif's iterations
    assert rec.calls("pwm.em_round") == int(it.max()) > 0


def test_em_kernel_rounds_read_zero_off_cuda(tmp_path):
    """Off CUDA EM runs the plain round: ``--timing`` prints
    ``em.kernel_rounds`` as 0, and the benchmark's reader reads 0 while
    the job ran EM rounds."""
    argv = [MAFK, "-w", "8", "--device", "cpu", "--engine", "tpu", "-o",
            str(tmp_path / "o.meme"), "--timing"]
    job = bench_run.run_job(cli.main, engine, argv, {}, "cpu")
    assert job["rc"] == 0
    assert "[COUNT] em.kernel_rounds: 0\n" in job["stderr"]
    rec = {"jobs": [job]}
    assert bench_run.reader(REPO, "em_kernel_rounds_per_job")(rec) == 0.0
    assert bench_run.reader(REPO, "em_rounds_per_job")(rec) > 0


def test_climb_kernel_counters_read_zero_off_cuda(tmp_path):
    """Off CUDA the climb takes the dense torch step: ``--timing`` prints
    ``climb.kernel_steps`` and ``climb.ids`` as 0, and the benchmark's
    readers read 0 while the job's climb ran steps."""
    argv = [MAFK, "-w", "8", "--device", "cpu", "--engine", "tpu", "-o",
            str(tmp_path / "o.meme"), "--timing"]
    job = bench_run.run_job(cli.main, engine, argv, {}, "cpu")
    assert job["rc"] == 0
    assert "[COUNT] climb.kernel_steps: 0\n" in job["stderr"]
    assert "[COUNT] climb.ids: 0\n" in job["stderr"]
    rec = {"jobs": [job]}
    for metric in ("climb_kernel_steps_per_job", "climb_ids_per_job"):
        assert bench_run.reader(REPO, metric)(rec) == 0.0
    assert bench_run.reader(REPO, "climb_steps_per_job")(rec) > 0


@pytest.mark.parametrize("engine_flag", ["tpu", "exact"])
def test_output_is_the_same_with_timing_and_profile(engine_flag, tmp_path,
                                                    kept):
    plain = _job(tmp_path, engine_flag=engine_flag)
    timed = _job(tmp_path, "--timing", engine_flag=engine_flag)
    profiled = _job(tmp_path, "--profile", str(tmp_path / "p"),
                    engine_flag=engine_flag)
    assert plain[0] == timed[0] == profiled[0]
    assert plain[2] == timed[2] == profiled[2]
    assert "[TIMING]" not in plain[1] and "[TIMING]" in timed[1]


def test_profile_trace_holds_every_span(kept, tmp_path, monkeypatch):
    """A range for every main-thread span (its own record_function): the
    host count's (forced here) among them; and a worker thread's span,
    the exact engine's lazy background scan, added at export inside its
    parent's."""
    def trace(rec, where):
        with open(tmp_path / where / "trace.json") as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X"]
        names = {e["name"] for e in events}
        home = threading.get_native_id()
        for s in rec.spans:
            if s.thread == home:
                assert s.path in names, s.path
        return events

    def interval(events, name):
        (e,) = [e for e in events if e["name"] == name
                and e.get("cat") == "user_annotation"]
        return e["ts"], e["ts"] + e["dur"]

    monkeypatch.setattr(hybrid, "count_on_host", lambda *a: True)
    _, _, _, rec = _job(tmp_path, "--profile", str(tmp_path / "p"))
    events = trace(rec, "p")
    assert {s.path for s in rec.spans if s.traced} >= set(TOP)
    count, host = interval(events, "count"), interval(events, "count.host")
    assert count[0] <= host[0] <= host[1] <= count[1]
    _, _, _, rec = _job(tmp_path, "--profile", str(tmp_path / "q"),
                        engine_flag="exact")
    events = trace(rec, "q")
    bg = interval(events, "background")
    scan = interval(events, "background.bg_scan")
    slack = 50.0                  # us: the anchor's read of two clocks
    assert bg[0] - slack <= scan[0] <= scan[1]


def test_recorder_helpers_count_device_transfers():
    """upload and sync_read count what crosses to or from a device (the
    meta device stands in for a card here); host tensors count
    nothing."""
    with lu.PhaseTimer().activate() as rec:
        host = lu.upload(np.arange(6, dtype=np.int32), "cpu")
        lu.sync_read(host)
        assert rec.counters == {}
        dev = lu.upload(np.arange(6, dtype=np.int32), "meta", torch.int64)
        assert dev.device.type == "meta" and dev.dtype == torch.int64
        assert lu.sync_read(dev, lambda t: t.shape) == (6,)
        lu.upload(dev, "meta")                  # already there: no copy
        lu.upload(np.zeros(0, np.int32), "meta")   # nothing: no copy
    assert rec.counters == {"h2d.copies": 1, "h2d.bytes": 48, "syncs": 2}
    # outside a job nothing is recorded and nothing fails
    lu.upload(np.zeros(2), "meta")
    with lu.span("x"):
        lu.count("y")


def test_spans_nest_by_thread_and_report_totals():
    rec = lu.PhaseTimer()
    with rec.activate():
        with rec.phase("count"):
            with lu.span("seeds"):
                pass
            t = lu.start_thread("host_thread", lambda: lu.count("z", 3))
            t.join(timeout=60)
            assert not t.is_alive()
        with lu.span("count"):
            pass
    tot = rec.totals()
    assert list(tot) == ["count", "count.seeds", "count.host_thread"]
    assert tot["count"][1] == 2 and tot["count.seeds"][1] == 1
    assert rec.counters == {"z": 3}
    err = io.StringIO()
    rec.report(err)
    lines = err.getvalue().splitlines()
    assert lines[0].startswith("[TIMING] count: ") and lines[0].endswith(
        " ms (2)")
    assert lines[-4:] == ["[COUNT] syncs: 0", "[COUNT] h2d.copies: 0",
                          "[COUNT] h2d.bytes: 0", "[COUNT] z: 3"]
