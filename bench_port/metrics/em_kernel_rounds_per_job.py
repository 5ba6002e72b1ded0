"""Mean per job of the program's counter "em.kernel_rounds": EM's
rounds run by the round kernel (csrc/em.cu), every round on the card; a
program without the counter reads None."""

from bench_port.metrics._spans import counter, mean


def read(rec):
    return mean([counter(j, "em.kernel_rounds") for j in rec["jobs"]])
