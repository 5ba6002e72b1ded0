"""Mean per job of the program's counter "syncs": each point where the
host waits for the device (a blocking read of a device tensor, or an
upload)."""

from bench_port.metrics._spans import counter, mean


def read(rec):
    return mean([counter(j, "syncs") for j in rec["jobs"]])
