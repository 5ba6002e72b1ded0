"""Mean per job of the wall that no top-level span of the program covers
(the job's self time): the job's wall less the sum of its span paths
without a "." (host clock).  Only jobs whose report has the span
"parse" count."""

from bench_port.metrics._spans import mean


def read(rec):
    return mean([
        (j["wall"] - sum(s for p, s in j["phases"].items() if "." not in p))
        * 1e3 for j in rec["jobs"] if "parse" in j["phases"]])
