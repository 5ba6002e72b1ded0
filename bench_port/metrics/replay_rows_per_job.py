"""Mean per job of the program's counter "climb.replay_rows": the climb
rows the native replay (csrc/replay.cpp) wrote, each seed's row and the
rows its walk accepted up to where the seen set stopped it.  A program
without the counter reads None."""

from bench_port.metrics._spans import counter, mean


def read(rec):
    return mean([counter(j, "climb.replay_rows") for j in rec["jobs"]])
