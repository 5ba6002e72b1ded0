"""The reader of em_kernel_rounds_per_job on synthetic job reports: the
mean of the program's counter "em.kernel_rounds" over the jobs that
report it, None where no job does (a program without the counter)."""

from __future__ import annotations

import pytest

from bench_port import run as R


def read(rec):
    return R.reader(R.ROOT, "em_kernel_rounds_per_job")(rec)


def job(*lines):
    return {"wall": 0.3, "phases": {}, "stderr": "\n".join(lines) + "\n"}


def test_mean_of_the_counter_over_the_jobs():
    rec = {"jobs": [
        job("[TIMING] pwm.em_round: 1.0 ms (10)",
            "[COUNT] em.kernel_rounds: 10"),
        job("[COUNT] syncs: 90", "[COUNT] em.kernel_rounds: 8"),
    ]}
    assert read(rec) == pytest.approx(9.0)


def test_zero_off_cuda_and_none_without_the_counter():
    assert read({"jobs": [job("[COUNT] em.kernel_rounds: 0")]}) == 0.0
    # the parent's report: EM rounds, but no such counter
    bare = job("[TIMING] pwm.em_round: 1.0 ms (10)",
               "[COUNT] climb.graph_steps: 21")
    assert read({"jobs": [bare]}) is None
    assert read({"jobs": []}) is None
