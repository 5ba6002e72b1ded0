"""The harness's CUDA context, made and synchronised before any job
(host clock); a CLI call pays it in its first job's span "device"."""

from bench_port.metrics._setup import parts_s


def read(rec):
    parts = parts_s(rec)
    return parts["context"] * 1e3 if parts else None
