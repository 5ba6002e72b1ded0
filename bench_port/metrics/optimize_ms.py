"""Mean per job of the program's ``--timing`` phase "optimize" (host clock)."""

from bench_port.metrics._common import mean_phase_ms


def read(rec):
    return mean_phase_ms(rec, "optimize")
