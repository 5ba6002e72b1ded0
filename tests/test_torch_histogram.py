"""The port's exact int32 histogram (peng_motif_tpu_torch/ops/histogram.py)
against the reference package's (peng_motif_tpu/ops/pallas_hist.py).

On the CPU the port's wrapper runs its plain PyTorch version; the
reference runs its dispatcher (the XLA scatter on the CPU) and each of
its three Pallas kernels in interpret mode.  The same numpy inputs,
made from a seed, go to both.  Tolerance: bit-identical (integer
counts).  The CUDA kernel itself runs only on a card: its tests are in
tests/test_torch_gpu.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peng_motif_tpu.ops import pallas_hist
from peng_motif_tpu_torch.ops import histogram as th


@pytest.fixture
def interpret(monkeypatch):
    """Pallas kernels in interpret mode (no TPU here)."""
    monkeypatch.setattr(pallas_hist.pl, "pallas_call", functools.partial(
        pallas_hist.pl.pallas_call, interpret=True))


def _inputs(n, n_bins, seed, frac=0.8):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n_bins, size=n).astype(np.int32)
    inc = (rng.random(n) < frac).astype(np.int32)
    return ids, inc


def _edge(name, n_bins, seed=0):
    """The four edge inputs: empty, all masked, one hot bin, last bin."""
    rng = np.random.default_rng(seed)
    n = 3000
    if name == "empty":
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    if name == "all_masked":
        return (rng.integers(0, n_bins, size=n).astype(np.int32),
                np.zeros(n, np.int32))
    if name == "one_hot_bin":
        return (np.full(n, n_bins // 3, np.int32),
                (rng.random(n) < 0.9).astype(np.int32))
    assert name == "last_bin"
    ids = rng.integers(0, n_bins, size=n).astype(np.int32)
    ids[::5] = n_bins - 1
    return ids, (rng.random(n) < 0.7).astype(np.int32)


EDGES = ["empty", "all_masked", "one_hot_bin", "last_bin"]


def _port(ids, inc, n_bins, inc_dtype=torch.int32):
    return th.histogram(torch.from_numpy(ids),
                        torch.from_numpy(inc).to(inc_dtype), n_bins).numpy()


def _ref(fn, ids, inc, n_bins, **kw):
    return np.asarray(fn(jnp.asarray(ids), jnp.asarray(inc), n_bins, **kw))


@pytest.mark.parametrize("n_bins", [384] + [4 ** w for w in range(4, 13)])
def test_matches_reference_dispatcher(n_bins):
    ids, inc = _inputs(20_000, n_bins, seed=n_bins % 97)
    got = _port(ids, inc, n_bins)
    want = _ref(pallas_hist.histogram, ids, inc, n_bins)
    assert got.dtype == np.int32 and got.shape == (n_bins,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_bins", [384, 4 ** 4])
def test_matches_mxu_histogram(n_bins, interpret):
    ids, inc = _inputs(5000, n_bins, seed=1)
    np.testing.assert_array_equal(
        _port(ids, inc, n_bins),
        _ref(pallas_hist.mxu_histogram, ids, inc, n_bins))


def test_matches_mxu_histogram_sq(interpret):
    n_bins = 4 ** 5
    ids, inc = _inputs(5000, n_bins, seed=2)
    np.testing.assert_array_equal(
        _port(ids, inc, n_bins),
        _ref(pallas_hist.mxu_histogram_sq, ids, inc, n_bins))


def test_matches_mxu_histogram_blocked(interpret):
    n_bins = 4 ** 6
    ids, inc = _inputs(5000, n_bins, seed=3)
    np.testing.assert_array_equal(
        _port(ids, inc, n_bins),
        _ref(pallas_hist.mxu_histogram_blocked, ids, inc, n_bins,
             hi_block=8, block=1024))


@pytest.mark.parametrize("edge", EDGES)
def test_edge_inputs_match_reference(edge):
    n_bins = 4 ** 6
    ids, inc = _edge(edge, n_bins)
    np.testing.assert_array_equal(
        _port(ids, inc, n_bins),
        _ref(pallas_hist.histogram, ids, inc, n_bins))


@pytest.mark.parametrize("edge", EDGES)
def test_edge_inputs_match_mxu_histogram(edge, interpret):
    n_bins = 384
    ids, inc = _edge(edge, n_bins)
    np.testing.assert_array_equal(
        _port(ids, inc, n_bins),
        _ref(pallas_hist.mxu_histogram, ids, inc, n_bins))


@pytest.mark.parametrize("inc_dtype", [torch.bool, torch.uint8, torch.int32])
def test_inc_dtypes_agree(inc_dtype):
    n_bins = 4 ** 5
    ids, inc = _inputs(4000, n_bins, seed=4)
    want = _ref(pallas_hist.histogram, ids, inc, n_bins)
    np.testing.assert_array_equal(_port(ids, inc, n_bins, inc_dtype), want)


def test_masked_ids_are_never_read():
    """Ids of uncounted inputs may be anything, -1 included (the stream
    count passes -1 for invalid windows)."""
    ids, inc = _inputs(4000, 256, seed=5)
    ids_bad = np.where(inc == 0, -1, ids).astype(np.int32)
    np.testing.assert_array_equal(_port(ids_bad, inc, 256),
                                  _port(ids, inc, 256))


def test_cpu_path_launches_no_kernel():
    before = th.LAUNCHES
    ids, inc = _inputs(4000, 4 ** 8, seed=6)
    _port(ids, inc, 4 ** 8)
    _port(*_edge("empty", 384), 384)
    assert th.LAUNCHES == before


@pytest.mark.parametrize("bad", [
    "ids_int64", "inc_float", "two_dim", "length_mismatch",
    "not_contiguous", "zero_bins", "id_out_of_range"])
def test_rejects_bad_inputs(bad):
    ids = torch.arange(12, dtype=torch.int32)
    inc = torch.ones(12, dtype=torch.bool)
    n_bins = 16
    if bad == "ids_int64":
        ids = ids.to(torch.int64)
    elif bad == "inc_float":
        inc = inc.to(torch.float32)
    elif bad == "two_dim":
        ids, inc = ids.view(3, 4), inc.view(3, 4)
    elif bad == "length_mismatch":
        inc = inc[:5]
    elif bad == "not_contiguous":
        ids = torch.arange(24, dtype=torch.int32)[::2]
    elif bad == "zero_bins":
        n_bins = 0
    else:
        n_bins = 8
    with pytest.raises((TypeError, ValueError)):
        th.histogram(ids, inc, n_bins)
