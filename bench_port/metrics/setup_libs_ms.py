"""The process's first job's span paths that end in "lib.native" or
"lib.histogram", summed: the first load of the port's two libraries,
and their build where the checkout has none yet; 0 where the job loads
neither.  A part of ``setup_cold_ms`` (host clock, the program's
spans)."""

from bench_port.metrics._setup import libs_s


def read(rec):
    val = libs_s(rec)
    return val * 1e3 if val is not None else None
