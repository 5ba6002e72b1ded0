"""The port's batch count (peng_motif_tpu_torch/ops/counting.py:
count_patterns, CountJob and the pieces under them) against the
reference package's JAX counting on the same numpy inputs.

Inputs: the adversarial cases of tests/test_counting.py (tandem
repeats, homopolymers, Ns, short sequences), random W = 10 batches with
Ns, and the 70,000-row ACGT batch of test_uint16_overflow_refetch.  The
port runs on CPU tensors, so its histogram takes the plain version.
Count tables and ltot must be identical.

The host count (csrc/hostcount.cpp, behind ``count_rows_exact_native``)
is held to the scan it replaced, pengnative.cpp's ``count_rows_exact``:
the same table and ltot at every W from 2 to 12, on both strands and on
the plus strand, at 1, 2, 8 and the hardware's threads, on corpora with
fewer and with more windows than 4**W (both sides of its replica rule).
"""

import ctypes
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_counting import CASES, encode, pad

from peng_motif_tpu.ops import counting as jcnt
from peng_motif_tpu.ops import encoding as jenc
from peng_motif_tpu_torch import native
from peng_motif_tpu_torch.ops import counting as tcnt
from peng_motif_tpu_torch.ops import encoding as tenc


def _jax_count(codes, W, both):
    counts, ltot = jcnt.count_patterns(jnp.asarray(codes), W, both)
    return np.asarray(counts, dtype=np.int64), int(ltot)


def _random_batch(seed, n_rows, lo, hi, n_frac):
    rng = np.random.default_rng(seed)
    seqs = []
    for n in rng.integers(lo, hi, size=n_rows):
        s = rng.integers(1, 5, size=int(n)).astype(np.uint8)
        s[rng.random(int(n)) < n_frac] = 0
        seqs.append(s)
    return pad(seqs)


@pytest.mark.parametrize("strings", CASES, ids=lambda c: "-".join(c)[:24])
@pytest.mark.parametrize("both", [True, False], ids=["both", "plus"])
@pytest.mark.parametrize("W", [4, 6, 8])
def test_count_patterns_matches_jax(strings, both, W):
    codes = pad([encode(s) for s in strings])
    want, want_ltot = _jax_count(codes, W, both)
    got, got_ltot = tcnt.count_patterns(codes, W, both)
    assert got.dtype == torch.int32
    assert got_ltot == want_ltot
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)


@pytest.mark.parametrize("both", [True, False], ids=["both", "plus"])
def test_count_patterns_w10_random_with_ns(both):
    codes = _random_batch(11, 9, 12, 300, 0.05)
    want, want_ltot = _jax_count(codes, 10, both)
    got, got_ltot = tcnt.count_patterns(codes, 10, both)
    assert got_ltot == want_ltot
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)


@pytest.mark.parametrize("path", ["host", "device"])
@pytest.mark.parametrize("strings", CASES, ids=lambda c: "-".join(c)[:24])
@pytest.mark.parametrize("both", [True, False], ids=["both", "plus"])
def test_count_job_matches_jax(strings, both, path, monkeypatch):
    """CountJob through both of its paths — the threaded native scan and
    the batch device program (forced by PENG_COUNT_HOST_MAX_BASES=0; on
    the CPU here) — gives the reference's table and ltot."""
    if path == "device":
        monkeypatch.setenv("PENG_COUNT_HOST_MAX_BASES", "0")
    codes = pad([encode(s) for s in strings])
    W = 6
    want, want_ltot = _jax_count(codes, W, both)
    counts, ltot = tcnt.CountJob(codes, W, both, "cpu").finish()
    assert counts.dtype == np.int32
    assert ltot == want_ltot
    np.testing.assert_array_equal(counts.astype(np.int64), want)


@pytest.mark.parametrize("both", [True, False], ids=["both", "plus"])
def test_count_job_device_w10_random_with_ns(both, monkeypatch):
    """W = 10 with Ns and tandem repeats (suspicious rows take the native
    row fix-up), batch device path against the host path and JAX."""
    codes = _random_batch(5, 40, 20, 400, 0.04)
    codes[3, :64] = np.tile(np.array([1, 2], dtype=np.uint8), 32)
    codes[7, :90] = 1
    want, want_ltot = _jax_count(codes, 10, both)
    host = tcnt.CountJob(codes, 10, both, "cpu").finish()
    monkeypatch.setenv("PENG_COUNT_HOST_MAX_BASES", "0")
    job = tcnt.CountJob(codes, 10, both, "cpu")
    assert job._host_thread is None  # the device path ran
    assert bool(job._susp.any())     # and took the row fix-up
    dev = job.finish()
    for counts, ltot in (host, dev):
        assert ltot == want_ltot
        np.testing.assert_array_equal(counts.astype(np.int64), want)


def test_count_job_70k_acgt_rows(monkeypatch):
    """70,000 single-window ACGT rows (palindromic: canonical id = itself)
    on the batch device path: the bin past the uint16 range the
    reference's wire refetches is exact in the port's int32 slice."""
    monkeypatch.setenv("PENG_COUNT_HOST_MAX_BASES", "0")
    codes = np.tile(np.array([[1, 2, 3, 4]], dtype=np.uint8), (70_000, 1))
    counts, ltot = tcnt.CountJob(codes, 4, True, "cpu").finish()
    acgt = 0 * 1 + 1 * 4 + 2 * 16 + 3 * 64
    assert counts[acgt] == 70_000
    assert ltot == 70_000
    assert counts.sum() == 70_000


def test_count_job_degenerate_inputs():
    for codes in (np.zeros((0, 0), np.uint8), np.ones((3, 5), np.uint8)):
        counts, ltot = tcnt.CountJob(codes, 6, True, "cpu").finish()
        assert ltot == 0 and counts.shape == (4 ** 6,) and not counts.any()


@pytest.mark.parametrize("W", [4, 6, 10])
def test_scan_skip_mask_matches_jax(W):
    codes = _random_batch(W, 12, 5, 260, 0.2)
    codes[0, 1::W + 1] = 0  # an N every W+1 bases: the longest skip chains
    fwd, rc, valid = jenc.window_ids(jnp.asarray(codes), W)
    want = np.asarray(jcnt.scan_skip_mask(
        jnp.asarray(codes, dtype=jnp.int32), valid, W))
    tvalid = tenc.window_ids(torch.from_numpy(codes), W)[2]
    got = tcnt.scan_skip_mask(torch.from_numpy(codes), tvalid, W)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any()


@pytest.mark.parametrize("both", [True, False], ids=["both", "plus"])
def test_host_row_recount_matches_jax(both):
    codes = _random_batch(3, 20, 8, 200, 0.1)
    codes[2, :40] = np.tile(np.array([1, 4], dtype=np.uint8), 20)
    codes[5, :33] = 2
    deltas = 0
    for row in codes:
        want = jcnt.host_row_recount(row, 6, both)
        assert tcnt.host_row_recount(row, 6, both) == want
        deltas += len(want)
    assert deltas > 0


# -- the host count (csrc/hostcount.cpp) --------------------------------------

HOST_THREADS = (1, 2, 8, 0)   # 0: the hardware's


def _replaced_count(codes, W, both):
    """pengnative.cpp's count_rows_exact on one thread: the scan and
    mirror the host count replaced."""
    table = np.empty(4 ** W, dtype=np.int32)
    ltot = native.get_lib().count_rows_exact(
        native._ptr(codes, ctypes.c_uint8), codes.shape[0], codes.shape[1],
        W, int(both), 1, native._ptr(table, ctypes.c_int32))
    return table, int(ltot)


def _host_corpus(kind, W):
    """A padded [B, L] code batch (0 = N) of one kind."""
    rng = np.random.default_rng(W)
    if kind == "n_rich":
        # 30% single Ns, runs of Ns, and an N every W+1 bases (the post-N
        # skip's longest chains)
        codes = rng.integers(1, 5, size=(64, 150)).astype(np.uint8)
        codes[rng.random(codes.shape) < 0.3] = 0
        codes[1, 20:60] = 0
        codes[2, 1::W + 1] = 0
        return codes
    if kind == "short_rows":
        # most sequences shorter than W, padded with Ns past their ends
        seqs = [rng.integers(1, 5, size=int(n)).astype(np.uint8)
                for n in rng.integers(1, W + 4, size=200)]
        return pad(seqs)
    if kind == "fewer_windows":
        # fewer windows than 4**W entries: the atomic adds at W >= 5
        n_rows = max(1, min(40, 4 ** W // 400))
        return rng.integers(1, 5, size=(n_rows, 100 + W)).astype(np.uint8)
    if kind == "more_windows":
        # three windows per table entry: the replicas at 2 and 8 threads
        n_rows = -(-3 * 4 ** W // 1000)
        return rng.integers(1, 5, size=(n_rows, 1000 + W - 1)).astype(
            np.uint8)
    # tandem repeats whose windows are their own reverse complements
    # (ACGT..., AT..., AATT...), a homopolymer, and Ns among them
    rows = [np.resize(np.array(u, dtype=np.uint8), 160)
            for u in ([1, 2, 3, 4], [1, 4], [1, 1, 4, 4], [2, 3],
                      [3], [1, 2, 3, 4, 0])]
    return np.stack(rows + [rng.integers(1, 5, size=160).astype(np.uint8)])


_HOST_CASES = [(kind, W) for kind in ("n_rich", "short_rows",
                                      "fewer_windows", "more_windows",
                                      "palindromes")
               for W in range(2, 13)
               # 3 x 4**W windows past W = 10 is a 50-Mbase corpus
               if not (kind == "more_windows" and W > 10)]


@pytest.mark.parametrize("both", [True, False], ids=["both", "plus"])
@pytest.mark.parametrize("kind,W", _HOST_CASES,
                         ids=[f"{k}-w{w}" for k, w in _HOST_CASES])
def test_host_count_is_the_replaced_scan(kind, W, both):
    codes = _host_corpus(kind, W)
    windows = codes.shape[0] * max(0, codes.shape[1] - W + 1)
    if kind == "more_windows":
        assert windows >= 2 * 4 ** W
    if kind == "fewer_windows":
        assert windows < 4 ** W or W < 5
    want, want_ltot = _replaced_count(codes, W, both)
    for n_threads in HOST_THREADS:
        got, ltot = native.count_rows_exact_native(codes, W, both, n_threads)
        assert got.dtype == np.int32 and got.shape == (4 ** W,)
        assert ltot == want_ltot, n_threads
        np.testing.assert_array_equal(got, want, err_msg=str(n_threads))


def test_host_count_threads_beyond_the_cores():
    """Four threads a core, on both sides of the replica rule and in the
    mirror: a lost atomic add or a mirror write that met a read would
    change the table."""
    n_threads = 4 * (os.cpu_count() or 1)
    for kind, W, copies in (("fewer_windows", 12, 1), ("n_rich", 10, 1),
                            ("more_windows", 8, 2 * n_threads // 8 + 1)):
        codes = np.tile(_host_corpus(kind, W), (copies, 1))
        want, want_ltot = _replaced_count(codes, W, True)
        for _ in range(3):
            got, ltot = native.count_rows_exact_native(codes, W, True,
                                                       n_threads)
            assert ltot == want_ltot
            np.testing.assert_array_equal(got, want, err_msg=kind)


def test_host_count_rows_shorter_than_w_and_no_rows():
    for codes in (np.ones((5, 7), np.uint8), np.zeros((0, 12), np.uint8)):
        for n_threads in HOST_THREADS:
            got, ltot = native.count_rows_exact_native(codes, 8, True,
                                                       n_threads)
            assert ltot == 0 and got.shape == (4 ** 8,) and not got.any()


def _rc_ids(W):
    """(ids, their reverse complements) of every W-mer, from the
    reverse complements of its low and high halves."""
    def rc_of(k):
        x = np.arange(4 ** k, dtype=np.int64)
        r = np.zeros_like(x)
        for p in range(k):
            r = r * 4 + (3 - (x >> (2 * p)) % 4)
        return r

    lo_k = W - W // 2
    ids = np.arange(4 ** W, dtype=np.int64)
    rc = (rc_of(lo_k)[ids % 4 ** lo_k] * 4 ** (W // 2)
          + rc_of(W // 2)[ids >> (2 * lo_k)])
    return ids, rc


@pytest.mark.parametrize("W", range(1, 13))
def test_host_count_mirror_copies_each_canonical_count(W):
    """The parallel mirror in place: each larger id of a pair takes its
    smaller id's count, and palindromes keep theirs."""
    rng = np.random.default_rng(W)
    table = rng.integers(0, 1 << 20, size=4 ** W).astype(np.int32)
    ids, rc = _rc_ids(W)
    want = table.copy()
    lo = ids < rc
    want[rc[lo]] = table[ids[lo]]
    pal = ids == rc
    assert pal.any() == (W % 2 == 0)
    for n_threads in HOST_THREADS:
        got = table.copy()
        native.get_lib().host_count_mirror(
            native._ptr(got, ctypes.c_int32), W, n_threads)
        np.testing.assert_array_equal(got, want, err_msg=str(n_threads))
        np.testing.assert_array_equal(got[pal], table[pal])
