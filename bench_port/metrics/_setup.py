"""The set-up's parts, from a run's record: ``warmup``, the jobs before
the window in the order they ran (the first is the process's cold job,
whose report holds the program's cold-start spans), ``context_s`` (the
harness's CUDA context, made and synchronised) and ``setup_s``.  Every
part reads None where the cold job's report lacks ``setup.import`` (off
Linux, or a process whose first job ran before the run), so the parts
read together or not at all."""

from __future__ import annotations

LIBS = ("lib.native", "lib.histogram")


def first_job(rec):
    """The process's first job, where its report holds ``setup.import``."""
    warm = rec.get("warmup")
    if not warm or "setup.import" not in warm[0]["phases"]:
        return None
    return warm[0]


def parts_s(rec):
    """{import, context, first_job, harness} in seconds, summing to
    ``setup_s``; None where there is no cold job to read."""
    job = first_job(rec)
    if job is None:
        return None
    out = {"import": job["phases"]["setup.import"],
           "context": rec["context_s"], "first_job": job["wall"]}
    out["harness"] = rec["setup_s"] - sum(out.values())
    return out


def libs_s(rec):
    """The cold job's span paths ending in a library's first load, summed
    (0 where the job loaded none, as where a library came up before it)."""
    job = first_job(rec)
    if job is None:
        return None
    return sum(s for p, s in job["phases"].items()
               if any(p == k or p.endswith("." + k) for k in LIBS))
