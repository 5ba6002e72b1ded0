"""Mean per job of the host's time a climb step: the program's span
"optimize.step" (one a lockstep step, ending in its sync) over its
calls (host clock)."""

from bench_port.metrics._spans import calls, mean


def read(rec):
    def per_step(job):
        n = calls(job, "optimize.step")
        if not n or "optimize.step" not in job["phases"]:
            return None
        return job["phases"]["optimize.step"] * 1e3 / n
    return mean([per_step(j) for j in rec["jobs"]])
