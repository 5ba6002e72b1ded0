"""Mean per job of the program's span "count.seeds.sort": the native
z-score sort of the seed selection (host clock).  None where the program
has no such span."""

from bench_port.metrics._common import mean_phase_ms


def read(rec):
    return mean_phase_ms(rec, "count.seeds.sort")
