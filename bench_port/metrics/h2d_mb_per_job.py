"""Mean per job of the program's counter "h2d.bytes", in MB (1e6 bytes):
what the host copies to the device."""

from bench_port.metrics._spans import counter, mean


def read(rec):
    vals = [counter(j, "h2d.bytes") for j in rec["jobs"]]
    return mean([None if v is None else v / 1e6 for v in vals])
