"""Mean per job of the climb's lockstep steps: the calls of the
program's span "optimize.step"."""

from bench_port.metrics._spans import calls, mean


def read(rec):
    return mean([calls(j, "optimize.step") for j in rec["jobs"]])
