"""Peaks of uniform random bases, a share of them carrying one planted
site: the generator of the reference package's 51.2-Mbase bench corpus
(``bench.py:58-80``, there with seed 7), with the seed as a parameter.

``params``: ``n_seq`` sequences of ``length`` bases; with probability
``rate`` a sequence carries one site at a uniform position, ``sites[1]``
in odd sequences and ``sites[0]`` in even ones."""

from __future__ import annotations

import numpy as np


def write(path: str, params: dict, seed: int, root: str) -> int:
    rng = np.random.default_rng(seed)
    let = np.frombuffer(b"ACGT", dtype=np.uint8)
    n_seq, L = params["n_seq"], params["length"]
    rows = let[rng.integers(0, 4, size=(n_seq, L))]
    sel = rng.random(n_seq) < params["rate"]
    sites = [np.frombuffer(s.encode(), dtype=np.uint8)
             for s in params["sites"]]
    width = sites[0].shape[0]
    pos = rng.integers(0, L - width, size=n_seq)
    for i in np.flatnonzero(sel):
        rows[i, pos[i]:pos[i] + width] = sites[i & 1]
    heads = [b">s%d\n" % i for i in range(n_seq)]
    nl = np.full((n_seq, 1), ord("\n"), dtype=np.uint8)
    body = np.concatenate([rows, nl], axis=1)
    with open(path, "wb") as f:
        for i in range(n_seq):
            f.write(heads[i])
            f.write(body[i].tobytes())
    return n_seq * L
