"""The port's batch count (peng_motif_tpu_torch/ops/counting.py:
count_patterns, CountJob and the pieces under them) against the
reference package's JAX counting on the same numpy inputs.

Inputs: the adversarial cases of tests/test_counting.py (tandem
repeats, homopolymers, Ns, short sequences), random W = 10 batches with
Ns, and the 70,000-row ACGT batch of test_uint16_overflow_refetch.  The
port runs on CPU tensors, so its histogram takes the plain version.
Count tables and ltot must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_counting import CASES, encode, pad

from peng_motif_tpu.ops import counting as jcnt
from peng_motif_tpu.ops import encoding as jenc
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
