"""Mean per job of the program's counter "climb.ids": the table ids the
climb kernel (csrc/climb.cu) read over the job, the candidates' mask
sets (and, under both strands, their reverse complements and the two
sets' intersections) less the ids that are not canonical there; it grows
as walks widen to degenerate patterns.  A program without the counter
reads None."""

from bench_port.metrics._spans import counter, mean


def read(rec):
    return mean([counter(j, "climb.ids") for j in rec["jobs"]])
