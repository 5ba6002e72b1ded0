"""The process's first job's wall less the median wall of the window's
jobs: the cold costs inside the job a CLI call runs, a part of
``setup_first_job_ms`` (host clock).  Read as it comes, below 0 too."""

import statistics

from bench_port.metrics._setup import parts_s


def read(rec):
    parts = parts_s(rec)
    if parts is None or not rec["jobs"]:
        return None
    window = statistics.median(j["wall"] for j in rec["jobs"])
    return (parts["first_job"] - window) * 1e3
