"""Mean per job of the program's counter "h2d.copies": host-to-device
copies."""

from bench_port.metrics._spans import counter, mean


def read(rec):
    return mean([counter(j, "h2d.copies") for j in rec["jobs"]])
