"""Mean per job of the program's span "redundancy": the redundancy
filter after merging (host clock)."""

from bench_port.metrics._common import mean_phase_ms


def read(rec):
    return mean_phase_ms(rec, "redundancy")
