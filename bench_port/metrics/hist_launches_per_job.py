"""Histogram kernel launches per window job (the program's counter
``ops.histogram.LAUNCHES``)."""


def read(rec):
    return rec["launches"] / len(rec["jobs"]) if rec["jobs"] else None
