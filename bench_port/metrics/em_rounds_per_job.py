"""Mean per job of EM's rounds: the calls of the program's span
"pwm.em_round"."""

from bench_port.metrics._spans import calls, mean


def read(rec):
    return mean([calls(j, "pwm.em_round") for j in rec["jobs"]])
