"""Mean per job of the program's span "count.seeds": the host background
table, z-scores and seed selection (host clock)."""

from bench_port.metrics._common import mean_phase_ms


def read(rec):
    return mean_phase_ms(rec, "count.seeds")
