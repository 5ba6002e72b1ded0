"""Mean per job of the program's counter "climb.graph_steps": the
climb's lockstep steps replayed from its CUDA graph (every step but the
first on the card)."""

from bench_port.metrics._spans import counter, mean


def read(rec):
    return mean([counter(j, "climb.graph_steps") for j in rec["jobs"]])
