"""The program's span "setup.import" in the process's first job: process
start to the end of the package's import (the interpreter, torch, the
program), as a CLI call pays it (host clock)."""

from bench_port.metrics._setup import parts_s


def read(rec):
    parts = parts_s(rec)
    return parts["import"] * 1e3 if parts else None
