"""Mean per job of the program's counter "climb.kernel_steps": the
climb's lockstep steps whose mutant aggregates came from the climb
kernel (csrc/climb.cu), every step on the card; a program without the
counter reads None."""

from bench_port.metrics._spans import counter, mean


def read(rec):
    return mean([counter(j, "climb.kernel_steps") for j in rec["jobs"]])
