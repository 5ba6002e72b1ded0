"""The wall of the process's first job: the job a CLI call runs, cold
(host clock)."""

from bench_port.metrics._setup import parts_s


def read(rec):
    parts = parts_s(rec)
    return parts["first_job"] * 1e3 if parts else None
