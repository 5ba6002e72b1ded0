"""The plain reference against brute force: the count layer against a
literal transcription of the upstream scan, the background model and a
pattern's statistics against per-id loops."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bench_port import reference as R
from bench_port.reference import count as C
from bench_port.reference import motifs as M


def scan(seq, W):
    """The upstream scan of one sequence (base_pattern.cpp:331-441),
    line by line: {canonical id: count}, ltot."""
    counts, last, ltot, i, L = {}, {}, 0, 0, len(seq)
    while i < L:
        p = pid = 0
        while p < W and i < L and seq[i] > 0:
            pid += (seq[i] - 1) * 4 ** p
            p += 1
            i += 1
        if p < W:
            i += 1
            continue
        while True:
            s = i - W
            rc = sum((3 - (pid >> (2 * q)) % 4) * 4 ** (W - 1 - q)
                     for q in range(W))
            cid = min(pid, rc)
            if cid not in last or last[cid] + W <= s:
                counts[cid] = counts.get(cid, 0) + 1
                last[cid] = s
            ltot += 1
            if i >= L or seq[i] == 0:
                break
            pid = pid // 4 + (seq[i] - 1) * 4 ** (W - 1)
            i += 1
        i += 2
    return counts, ltot


def corpus(seed, n=12, lmax=60, n_rate=0.04, alphabet=4):
    rng = np.random.default_rng(seed)
    seqs = []
    for _ in range(n):
        s = rng.integers(1, 1 + alphabet, size=int(rng.integers(1, lmax)))
        s[rng.random(s.shape[0]) < n_rate] = 0
        seqs.append(s.astype(np.uint8))
    codes = np.concatenate(seqs)
    offsets = np.concatenate([[0], np.cumsum([len(s) for s in seqs])])
    return seqs, codes, offsets.astype(np.int64)


@pytest.mark.parametrize("seed,W,alphabet", [(0, 4, 4), (1, 6, 4), (2, 4, 2),
                                             (3, 8, 2), (4, 6, 1)])
def test_count_table_is_the_upstream_scan(seed, W, alphabet):
    """Random sequences with Ns; two- and one-letter alphabets make the
    repeats where the overlap rule decides."""
    seqs, codes, offsets = corpus(seed, alphabet=alphabet)
    want = np.zeros(4 ** W, np.int64)
    ltot = 0
    for s in seqs:
        c, lt = scan([int(x) for x in s], W)
        ltot += lt
        for k, v in c.items():
            want[k] += v
    rc = C.revcomp_ids(W)
    want = want[np.minimum(np.arange(4 ** W), rc)]
    table, got_ltot = C.count_table(codes, offsets, W)
    assert got_ltot == ltot
    np.testing.assert_array_equal(table, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bg_counts_are_per_window(seed):
    seqs, codes, offsets = corpus(seed, n_rate=0.08)
    got = C.bg_counts(codes, offsets, 2)
    for k in range(3):
        want = np.zeros(4 ** (k + 1), np.int64)
        for s in seqs:
            for i in range(k, len(s)):
                win = s[i - k:i + 1]
                v = sum(max(int(c) - 1, 0) * 4 ** (k - j)
                        for j, c in enumerate(win))
                near_n = (s[max(0, i - 8):i + 1] == 0).any()
                if not near_n or v == 0:
                    want[v] += 1
        np.testing.assert_array_equal(got[k], want)


def test_read_fasta(tmp_path):
    p = tmp_path / "x.fa"
    p.write_bytes(b">a\nACGT\nNNac\n>empty\n>b\nTTTT\n>c\nGG")
    codes, offsets = C.read_fasta(str(p))
    assert offsets.tolist() == [0, 8, 12]
    assert codes.tolist() == [1, 2, 3, 4, 0, 0, 1, 2, 4, 4, 4, 4]


def test_background_and_statistics_per_id():
    rng = np.random.default_rng(5)
    W = 4
    bg = [rng.integers(1, 50, 4 ** (k + 1)) for k in range(3)]
    v = M.conditionals(bg)
    for k in range(3):
        assert np.allclose(v[k].reshape(-1, 4).sum(1), 1, atol=1e-6)
    p = M.bg_prob(v, W, 2, "cpu").numpy()
    for pid in range(4 ** W):
        d = [(pid >> (2 * q)) & 3 for q in range(W)]
        want = np.float32(1)
        for pos in range(W):
            k = min(pos, 2)
            ctx = 0
            for c in d[pos - k:pos + 1]:
                ctx = ctx * 4 + c
            want = np.float32(want * v[k][ctx])
        assert p[pid] == want
    table = rng.integers(0, 30, 4 ** W)
    rc = C.revcomp_ids(W)
    table = np.maximum(table, table[rc])          # mirrored
    t = M.Tables(W, torch.from_numpy(table), 500, v, 2)
    n, mu, bgp = M.Aggregates(t)(["ASNW"])[0]
    pats = {pid for pid in range(4 ** W)
            if all("ACGT"[(pid >> (2 * q)) & 3] in M.IUPAC[c]
                   for q, c in enumerate("ASNW"))}
    canon = {min(pid, int(rc[pid])) for pid in pats} | \
        {min(pid, int(rc[pid])) for pid in range(4 ** W) if rc[pid] in pats}
    assert n == sum(int(table[c]) for c in canon)
    exp = t.expected.numpy()
    assert mu == pytest.approx(sum(float(exp[c]) for c in canon), rel=1e-6)


def test_em_matches_a_loop_over_ids():
    rng = np.random.default_rng(1)
    W = 3
    counts = rng.integers(0, 40, 4 ** W)
    bg = rng.random(4 ** W).astype(np.float32) + np.float32(0.1)
    pwm = M.normalize(rng.random((W, 4)).astype(np.float32) + 0.05)
    t = M.Tables(W, torch.from_numpy(counts), 900,
                 [np.full(4 ** (k + 1), 0.25, np.float32) for k in range(3)],
                 2)
    got, it = M.em(pwm, t, torch.from_numpy(bg), 1e4, 0.0, 1)
    s = np.float32(1e4)
    new = np.zeros((W, 4), np.float64)
    for pid in range(4 ** W):
        d = [(pid >> (2 * q)) & 3 for q in range(W)]
        prob = np.float32(1)
        for q in range(W):
            prob = np.float32(prob * pwm[q, d[q]])
        odds = np.float32(prob / bg[pid])
        r = np.float32(np.float32(counts[pid] * s)
                       / np.float32(np.float32(s / odds) + 1))
        for q in range(W):
            new[q, d[q]] += r
    want = new / new.sum(1, keepdims=True)
    assert it == 1
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1 + 2 ** -10, 1 + 2 ** -11, 1 + 2 ** -12, 3.14159])
    y = M.tf32(x)
    assert y[0] == 1.0 and y[1] == 1 + 2 ** -10
    assert y[2] == 1.0            # a tie to even
    assert y[3] == 1.0
    assert abs(float(y[4]) - 3.14159) < 2 ** -10 * 4


def test_pipeline_on_a_tiny_corpus(tmp_path):
    """End to end on a corpus with a planted site: motifs come out, and
    the control's differ from the reference's."""
    rng = np.random.default_rng(3)
    rows = rng.choice(list(b"ACGT"), size=(200, 150)).astype(np.uint8)
    for i in range(0, 200, 2):
        rows[i, 40:48] = np.frombuffer(b"TGACTCAC", np.uint8)
    p = tmp_path / "c.fa"
    p.write_bytes(b"".join(b">s\n" + r.tobytes() + b"\n" for r in rows))
    s = R.Settings(W=8)
    corpus_ = R.Corpus.of(str(p), s)
    t = R.tables(corpus_, s, "cpu")
    out = R.expected_motifs(t, corpus_, ["TGASTCAC", "GTGASTCA"], s)
    low = R.expected_motifs(t, corpus_, ["TGASTCAC", "GTGASTCA"], s,
                            control=True)
    assert out and out[0]["w"] >= 8
    assert all(abs(m["rows"].sum(1) - 1).max() < 1e-5 for m in out)
    assert max(abs(a["rows"] - b["rows"]).max()
               for a, b in zip(out, low)) > 1e-6


def test_the_search_is_the_upstream_binarys():
    """On MafK at -w 8 the reference selects the seeds, climbs and keeps
    the candidates that the upstream binary printed
    (``bench_port/data/upstream_mafk_w8.log``), its log's choices taken
    only between ties; the motifs it makes of them are the binary's
    within the cells' PWM limit."""
    import json
    import os

    from bench_port import compare as CP
    from bench_port.reference import climb as RC

    data = os.path.join(os.path.dirname(R.__file__), "..", "data")
    with open(os.path.join(data, "upstream_mafk_w8.log")) as f:
        log = CP.parse_stdout(f.read())
    s = R.Settings(W=8)
    corpus_ = R.Corpus.of(os.path.join(data, "MafK.fasta"), s)
    t = R.tables(corpus_, s, "cpu")
    found = RC.search(t, M.Aggregates(t), corpus_.n_seq, 10.0, 3, 50,
                      job=log)
    assert found.seeds == [r[0] for r in log["seeds"]]
    assert len(found.climbs) == len(log["climbs"]) == 50
    for got, want in zip(found.climbs, log["climbs"]):
        assert (got.seed, got.rows, got.emitted) == (
            want["seed"], [r[0] for r in want["rows"]], want["emitted"])
    assert found.selected == log["selected"]
    with open(os.path.join(data, "upstream_mafk_w8.meme")) as f:
        meme = CP.parse_meme(f.read())
    mine = R.expected_motifs(t, corpus_, found.selected, s,
                             merges=log["merges"])
    with open(os.path.join(data, "..", "limits", "mafk_w10.json")) as f:
        pwm_limit = json.load(f)["pwm_err"]
    cmp = CP.compare_motifs(meme, mine)
    assert cmp["motif_mismatch"] == 0 and cmp["pwm_err"] <= pwm_limit


@pytest.mark.parametrize("obs,exp_,n", [(28, 4.24, 100), (52, 8.57, 100),
                                        (195, 66.36, 5000), (3, 9.0, 50)])
def test_mutual_information_score_per_term(obs, exp_, n):
    """The vectorised score against the formula written out per prior
    (utils.h:10-37), float storage and double logarithms."""
    from bench_port.reference import climb as RC

    f = np.float32

    def h(p):
        p = float(p)
        return f(-p * np.log(p) - (1 - p) * np.log(1 - p))

    o, e = f(obs), f(exp_)
    if o < e:
        want = f(0)
    else:
        p_o = f(1 - np.exp(float(-(o / f(n)))))
        p_e = f(1 - np.exp(float(-(e / f(n)))))
        total = f(0)
        for q in (f(0.5), f(0.1), f(0.01)):
            p = f(f(p_o * q) + f(p_e * f(f(1) - q)))
            mi = f(f(f(-q * h(p_o)) - f(f(f(1) - q) * h(p_e))) + h(p))
            total = f(total + f(mi / h(q)))
        want = f(-total)
    assert RC.mi_score([obs], [exp_], n)[0] == want
