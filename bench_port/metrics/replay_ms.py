"""Mean per job of the program's span "replay": the climb's host replay,
the IUPAC filter and their printing (host clock)."""

from bench_port.metrics._common import mean_phase_ms


def read(rec):
    return mean_phase_ms(rec, "replay")
