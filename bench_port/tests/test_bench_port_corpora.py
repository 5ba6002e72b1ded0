"""The corpus generators are deterministic in the seed, and the planted
peaks are the reference package's bench corpus at its seed."""

from __future__ import annotations

import numpy as np
import pytest

from bench_port import run as R

ROOT = R.ROOT
SMALL = {"n_seq": 60, "length": 300, "rate": 0.3,
         "sites": ["TGAGTCAC", "TGACTCAC"]}


def gen(name):
    return R.load_module(f"{ROOT}/bench_port/corpora/{name}.py")


@pytest.mark.parametrize("name,params", [
    ("planted_peaks", SMALL),
    ("peaks_shuffled", {"fasta": "bench_port/data/MafK.fasta"})])
def test_same_seed_same_bytes(tmp_path, name, params):
    g = gen(name)
    a, b, c = (tmp_path / x for x in "abc")
    g.write(str(a), params, 2 ** 40 + 3, ROOT)
    g.write(str(b), params, 2 ** 40 + 3, ROOT)
    g.write(str(c), params, 5, ROOT)
    assert a.read_bytes() == b.read_bytes() != c.read_bytes()


def test_shuffle_keeps_the_peaks(tmp_path):
    out = tmp_path / "s.fa"
    n = gen("peaks_shuffled").write(str(out), {
        "fasta": "bench_port/data/MafK.fasta"}, 9, ROOT)
    src = open(f"{ROOT}/bench_port/data/MafK.fasta", "rb").read()
    def peaks(data):
        return sorted(r.partition(b"\n")[2].replace(b"\n", b"")
                      for r in data.split(b">")[1:])
    assert n == 1_025_000
    assert peaks(out.read_bytes()) == peaks(src)


def test_planted_peaks_is_the_bench_corpus(tmp_path):
    """bench.py:58-80 (seed 7), written out here so that this test reads
    no file of the JAX package's bench."""
    out = tmp_path / "p.fa"
    gen("planted_peaks").write(str(out), SMALL, 7, ROOT)
    rng = np.random.default_rng(7)
    let = np.frombuffer(b"ACGT", dtype=np.uint8)
    n_seq, L = 60, 300
    rows = let[rng.integers(0, 4, size=(n_seq, L))]
    sel = rng.random(n_seq) < 0.3
    mot_c = np.frombuffer(b"TGACTCAC", dtype=np.uint8)
    mot_g = np.frombuffer(b"TGAGTCAC", dtype=np.uint8)
    pos = rng.integers(0, L - 8, size=n_seq)
    for i in np.flatnonzero(sel):
        rows[i, pos[i]: pos[i] + 8] = mot_c if (i & 1) else mot_g
    want = b"".join(b">s%d\n" % i + rows[i].tobytes() + b"\n"
                    for i in range(n_seq))
    assert out.read_bytes() == want
