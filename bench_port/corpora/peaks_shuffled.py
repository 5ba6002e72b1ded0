"""A bundled peak set in an order drawn from the seed.

``params``: ``fasta``, the peak set's path relative to the checkout.
The records are written whole, each as one header line and one sequence
line, in a permutation drawn from ``seed``; the set of peaks, and so the
count table and the motifs, does not depend on the order."""

from __future__ import annotations

import os

import numpy as np


def write(path: str, params: dict, seed: int, root: str) -> int:
    with open(os.path.join(root, params["fasta"]), "rb") as f:
        recs = f.read().split(b">")[1:]
    peaks = []
    for rec in recs:
        head, _, body = rec.partition(b"\n")
        peaks.append((head, body.replace(b"\n", b"")))
    order = np.random.default_rng(seed).permutation(len(peaks))
    with open(path, "wb") as f:
        for i in order:
            f.write(b">" + peaks[i][0] + b"\n" + peaks[i][1] + b"\n")
    return sum(len(p[1]) for p in peaks)
