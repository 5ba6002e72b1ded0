"""Seconds from process start to the first timed job: import, CUDA
context, corpus, the traffic's set-up, warm-up jobs (which build the
libraries on a checkout's first run)."""


def read(rec):
    return rec["setup_s"]
