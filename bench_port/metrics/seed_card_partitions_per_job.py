"""Mean per job of the program's counter "seeds.card_partitions": the
partitions of the seed z-sort run on the card (0 where the host sorts the
whole table).  None where the program has no such counter."""

from bench_port.metrics._spans import counter, mean


def read(rec):
    return mean([counter(j, "seeds.card_partitions") for j in rec["jobs"]])
