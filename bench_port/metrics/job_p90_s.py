"""The 90th percentile of the walls of all the window's jobs (host
clock; Python's ``statistics.quantiles``, exclusive method)."""

import statistics


def read(rec):
    walls = [j["wall"] for j in rec["jobs"]]
    if len(walls) < 2:
        return None
    return statistics.quantiles(walls, n=10)[8]
