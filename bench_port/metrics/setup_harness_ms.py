"""``setup_s`` less the three parts a CLI call pays (the program's
import, the CUDA context, the first job): what only the benchmark's
process pays, as its own imports, nvidia-smi, the corpus and the later
warm-up jobs (host clock)."""

from bench_port.metrics._setup import parts_s


def read(rec):
    parts = parts_s(rec)
    return parts["harness"] * 1e3 if parts else None
