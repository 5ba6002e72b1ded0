"""Window seconds over the jobs completed in it: the time per job over
all the window's work and time (host clock)."""


def read(rec):
    return rec["window_s"] / len(rec["jobs"]) if rec["jobs"] else None
