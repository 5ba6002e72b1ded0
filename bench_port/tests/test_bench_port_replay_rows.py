"""The reader of replay_rows_per_job on synthetic job reports: the mean
of the program's counter "climb.replay_rows" over the jobs that report
it, None where no job does (a program without the counter)."""

from __future__ import annotations

import pytest

from bench_port import run as R


def read(rec):
    return R.reader(R.ROOT, "replay_rows_per_job")(rec)


def job(*lines):
    return {"wall": 0.3, "phases": {}, "stderr": "\n".join(lines) + "\n"}


def test_a_job_reads_its_printed_rows():
    rec = {"jobs": [job("[TIMING] replay: 4.6 ms (1)",
                        "[COUNT] climb.replay_rows: 797")]}
    assert read(rec) == 797.0


def test_mean_of_the_counter_over_the_jobs():
    rec = {"jobs": [job("[COUNT] climb.replay_rows: 797"),
                    job("[COUNT] syncs: 90", "[COUNT] climb.replay_rows: 802")]}
    assert read(rec) == pytest.approx(799.5)


def test_none_without_the_counter():
    # the parent's report: the replay's span, no such counter
    bare = job("[TIMING] replay: 52.4 ms (1)", "[COUNT] climb.ids: 7100935")
    assert read({"jobs": [bare]}) is None
    assert read({"jobs": []}) is None
