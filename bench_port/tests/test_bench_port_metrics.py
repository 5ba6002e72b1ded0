"""The metric arithmetic on synthetic records and traces."""

from __future__ import annotations

import statistics

import pytest

from bench_port import run as R
from bench_port import tracing as T

ROOT = R.ROOT


def read(name, rec):
    return R.reader(ROOT, name)(rec)


def test_union_and_merged():
    spans = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (10, 10)]
    assert T.union(spans) == 4
    assert T.merged(spans) == [[0, 3], [5, 6], [10, 10]]
    assert T.union([]) == 0


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def trace_events():
    return [
        ev("user_annotation", "bench_port.traced_jobs", 0, 1000),
        ev("user_annotation", "phase:count", 0, 400),
        ev("user_annotation", "phase:optimize", 400, 600),
        ev("cpu_op", "aten::copy_", 100, 50),
        ev("cpu_op", "aten::sum", 600, 300),
        ev("cpu_op", "aten::sum_inner", 700, 100),
        ev("kernel", "void hist_l2_kernel(int const*)", 150, 100),
        ev("kernel", "hist_shared_kernel", 200, 100),
        ev("gpu_memcpy", "Memcpy HtoD", 450, 100),
        ev("kernel", "outside", 1100, 50),
    ]


def test_reduce_busy_idle_and_breakdown():
    out = T.reduce(trace_events())
    assert out["window_s"] == pytest.approx(1e-3)
    assert out["busy_s"] == pytest.approx(250e-6)     # 150-300, 450-550
    assert out["hist_s"] == pytest.approx(200e-6)
    ops = dict(out["breakdown"]["device_ops"])
    assert ops["void hist_l2_kernel(int const*)"] == pytest.approx(100e-6)
    assert "outside" not in ops
    gaps = dict(out["breakdown"]["idle_gaps"])
    assert gaps["optimize/aten::sum_inner"] == pytest.approx(450e-6)
    assert gaps["count/host"] == pytest.approx(300e-6)   # 0-150, 300-450
    rec = {"trace": out}
    assert read("device_idle_pct", rec) == pytest.approx(75.0)


def test_roofline_share():
    bound = (5 * 1_000_000 + 4 * 4 ** 10) / 3.35e12
    rec = {"device_kind": "NVIDIA H100 80GB HBM3",
           "trace": {"hist_calls": [(1_000_000, 4 ** 10)] * 2,
                     "hist_s": 4 * bound}}
    assert read("hist_roofline_pct", rec) == pytest.approx(50.0)
    # nothing to read: no share at all, never 0
    assert read("hist_roofline_pct", dict(rec, trace=dict(
        rec["trace"], hist_calls=[]))) is None
    assert read("hist_roofline_pct", dict(rec, device_kind="cpu")) is None
    assert read("hist_roofline_pct", dict(rec, trace=None)) is None


def jobs(walls, phases=None):
    return [{"wall": w, "phases": phases or {}} for w in walls]


def test_job_rate_tail_and_phases():
    walls = [0.1 * (i + 1) for i in range(20)]
    ph = {"count": 0.01, "optimize": 0.02, "pwm": 0.03, "em+merge": 0.04}
    rec = {"jobs": jobs(walls, ph), "window_s": 4.2, "setup_s": 9.5,
           "launches": 40, "trace": None}
    assert read("job_s", rec) == pytest.approx(0.21)
    assert read("job_p90_s", rec) == statistics.quantiles(walls, n=10)[8]
    assert read("job_p90_s", rec) == pytest.approx(1.89)
    assert read("setup_s", rec) == 9.5
    assert read("count_ms", rec) == pytest.approx(10.0)
    assert read("merge_ms", rec) == pytest.approx(40.0)
    assert read("cli_other_ms", rec) == pytest.approx(
        (statistics.fmean(walls) - 0.1) * 1e3)
    assert read("hist_launches_per_job", rec) == 2.0
    assert read("device_idle_pct", rec) is None
    assert read("job_p90_s", dict(rec, jobs=jobs([1.0]))) is None


SETUP = ("setup_import_ms", "setup_context_ms", "setup_first_job_ms",
         "setup_cold_ms", "setup_libs_ms", "setup_harness_ms")


def setup_rec(first_phases, window_walls=(0.2, 0.3, 0.25, 0.9)):
    cold = {"wall": 3.5, "phases": first_phases}
    warm = {"wall": 0.4, "phases": {"count": 0.05}}
    return {"jobs": jobs(list(window_walls)), "setup_s": 12.0,
            "context_s": 0.6, "warmup": [cold, warm],
            "setup_marks": {"context": 4.6, "card": 4.8, "corpus": 4.9,
                            "first_warmup": 8.4}}


def test_setup_parts_sum_to_setup_s():
    rec = setup_rec({"setup.import": 4.0, "device": 1e-4, "count": 1.0,
                     "count.lib.native": 0.3, "lib.histogram": 0.5,
                     "pwm.lib.histogram.x": 9.0})
    got = {m: read(m, rec) for m in SETUP}
    assert got["setup_import_ms"] == pytest.approx(4000.0)
    assert got["setup_context_ms"] == pytest.approx(600.0)
    assert got["setup_first_job_ms"] == pytest.approx(3500.0)
    assert got["setup_harness_ms"] == pytest.approx(3900.0)
    assert sum(got[m] for m in ("setup_import_ms", "setup_context_ms",
                                "setup_first_job_ms", "setup_harness_ms")) \
        == pytest.approx(rec["setup_s"] * 1e3)
    # only paths that end in a library's span count, at any depth
    assert got["setup_libs_ms"] == pytest.approx(800.0)
    assert got["setup_libs_ms"] <= got["setup_first_job_ms"]


def test_setup_cold_is_the_first_job_less_the_window_median():
    rec = setup_rec({"setup.import": 4.0})
    # median of 0.2, 0.25, 0.3, 0.9 is 0.275: not the mean (0.4125)
    assert read("setup_cold_ms", rec) == pytest.approx((3.5 - 0.275) * 1e3)
    # read as it comes, below 0 too
    slow = setup_rec({"setup.import": 4.0}, window_walls=(4.0, 5.0, 6.0))
    assert read("setup_cold_ms", slow) == pytest.approx(-1500.0)
    assert read("setup_cold_ms", dict(rec, jobs=[])) is None


@pytest.mark.parametrize("metric", SETUP)
def test_setup_reads_none_without_the_cold_report(metric):
    """A first job whose report lacks setup.import (off Linux, or not the
    process's first) reads nothing; so does a run with no warm-up."""
    assert read(metric, setup_rec({"device": 0.5, "lib.native": 0.2})) \
        is None
    assert read(metric, dict(setup_rec({"setup.import": 1.0}),
                             warmup=[])) is None


def test_setup_libs_zero_where_no_library_loads():
    """A first job that loads no library (one loaded before it) reads 0,
    so the metric stays in every traced line of its cells."""
    rec = setup_rec({"setup.import": 4.0, "count": 1.0})
    assert read("setup_libs_ms", rec) == 0.0
    assert read("setup_first_job_ms", rec) == pytest.approx(3500.0)
