"""The readers of climb_kernel_steps_per_job and climb_ids_per_job on
synthetic job reports: the mean of the program's counters
"climb.kernel_steps" and "climb.ids" over the jobs that report them,
None where no job does (a program without the counters)."""

from __future__ import annotations

import pytest

from bench_port import run as R

READERS = {"climb_kernel_steps_per_job": "climb.kernel_steps",
           "climb_ids_per_job": "climb.ids"}


def read(metric, rec):
    return R.reader(R.ROOT, metric)(rec)


def job(*lines):
    return {"wall": 0.3, "phases": {}, "stderr": "\n".join(lines) + "\n"}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_mean_of_the_counter_over_the_jobs(metric):
    name = READERS[metric]
    rec = {"jobs": [
        job("[TIMING] optimize.step: 1.0 ms (25)", f"[COUNT] {name}: 25"),
        job("[COUNT] syncs: 90", f"[COUNT] {name}: 20"),
    ]}
    assert read(metric, rec) == pytest.approx(22.5)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_zero_off_cuda_and_none_without_the_counter(metric):
    name = READERS[metric]
    assert read(metric, {"jobs": [job(f"[COUNT] {name}: 0")]}) == 0.0
    # the parent's report: climb steps and graph replays, no such counter
    bare = job("[TIMING] optimize.step: 1.0 ms (25)",
               "[COUNT] climb.graph_steps: 24")
    assert read(metric, {"jobs": [bare]}) is None
    assert read(metric, {"jobs": []}) is None


def test_the_readers_do_not_read_each_other():
    rec = {"jobs": [job("[COUNT] climb.kernel_steps: 25",
                        "[COUNT] climb.ids: 1234567")]}
    assert read("climb_kernel_steps_per_job", rec) == 25.0
    assert read("climb_ids_per_job", rec) == 1234567.0
