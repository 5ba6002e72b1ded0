"""Mean per job of the wall outside the four ``--timing`` phases: FASTA
parse, background model, engine set-up, MEME write (host clock)."""

import statistics

PHASES = ("count", "optimize", "pwm", "em+merge")


def read(rec):
    rest = [j["wall"] - sum(j["phases"].get(p, 0.0) for p in PHASES)
            for j in rec["jobs"] if j["phases"]]
    return statistics.fmean(rest) * 1e3 if rest else None
