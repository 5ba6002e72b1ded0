"""Reading the program's own report, the ``--timing`` lines at the end
of each job's stderr: ``[TIMING] <path>: <ms> ms (<calls>)`` per span
path and ``[COUNT] <name>: <n>`` per counter.  A job whose report lacks
the line reads None, and a metric no job holds reads None."""

from __future__ import annotations

import re
import statistics

_TIMING = re.compile(r"^\[TIMING\] (.+): ([0-9.]+) ms \((\d+)\)$")
_COUNT = re.compile(r"^\[COUNT\] (\S+): (\d+)$")


def calls(job, path):
    """Calls of the span ``path`` in one job, or None."""
    for line in job["stderr"].splitlines():
        m = _TIMING.match(line)
        if m and m.group(1) == path:
            return int(m.group(3))
    return None


def counter(job, name):
    """The counter ``name`` of one job, or None."""
    for line in job["stderr"].splitlines():
        m = _COUNT.match(line)
        if m and m.group(1) == name:
            return int(m.group(2))
    return None


def mean(values):
    """Mean of the jobs' values that are not None; None if none is."""
    vals = [v for v in values if v is not None]
    return statistics.fmean(vals) if vals else None
