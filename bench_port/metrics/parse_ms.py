"""Mean per job of the program's span "parse": the FASTA parse (host
clock)."""

from bench_port.metrics._common import mean_phase_ms


def read(rec):
    return mean_phase_ms(rec, "parse")
