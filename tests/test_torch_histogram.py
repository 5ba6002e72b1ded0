"""The port's exact int32 histogram (peng_motif_tpu_torch/ops/histogram.py)
against the reference package's (peng_motif_tpu/ops/pallas_hist.py).

On the CPU the port's wrapper runs its plain PyTorch version; the
reference runs its dispatcher (the XLA scatter on the CPU) and each of
its three Pallas kernels in interpret mode.  The same numpy inputs,
made from a seed, go to both.  Tolerance: bit-identical (integer
counts).  The CUDA kernels themselves run only on a card: their tests are
in tests/test_torch_gpu.py.  What surrounds them runs here: the
dispatcher's plan (a pure function of the table size and the input
length), the accumulating ``out=`` entry, the bin-range passes emulated
with the plain version, and the edge inputs that the card's tests and
chip_smoke.py share (peng_motif_tpu_torch.bench_histogram.edge_input).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peng_motif_tpu.ops import pallas_hist
from peng_motif_tpu_torch import bench_histogram as tb
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
    before, by_card = th.LAUNCHES, dict(th.DEVICE_LAUNCHES)
    ids, inc = _inputs(4000, 4 ** 8, seed=6)
    _port(ids, inc, 4 ** 8)
    _port(*_edge("empty", 384), 384)
    assert th.LAUNCHES == before
    assert th.DEVICE_LAUNCHES == by_card


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
        # a counted id outside the table is dropped, as the reference's
        # scatter and the kernels drop it; nothing is written out of bounds
        n_bins = 8
        got = th.histogram(ids, inc, n_bins)
        assert got.tolist() == [1] * 8
        np.testing.assert_array_equal(
            got.numpy(), _ref(pallas_hist.histogram, ids.numpy(),
                              inc.numpy().astype(np.int32), n_bins))
        return
    with pytest.raises((TypeError, ValueError)):
        th.histogram(ids, inc, n_bins)


@pytest.mark.parametrize("bad", ["out_int64", "out_short", "out_two_dim",
                                 "out_not_contiguous"])
def test_rejects_bad_out(bad):
    ids = torch.arange(12, dtype=torch.int32)
    inc = torch.ones(12, dtype=torch.bool)
    out = {"out_int64": torch.zeros(16, dtype=torch.int64),
           "out_short": torch.zeros(15, dtype=torch.int32),
           "out_two_dim": torch.zeros(4, 4, dtype=torch.int32),
           "out_not_contiguous": torch.zeros(32, dtype=torch.int32)[::2],
           }[bad]
    with pytest.raises((TypeError, ValueError)):
        th.histogram(ids, inc, 16, out=out)


SIZES = [384] + [4 ** w for w in range(4, 13)]


@pytest.mark.parametrize("n_bins", SIZES + [th.SHARED_MAX_BINS,
                                            th.SHARED_MAX_BINS + 1])
def test_plan_tiles_the_table_within_the_card(n_bins):
    """The dispatcher's plan for a 50M-id input: the launches' bin ranges
    tile [0, n_bins) in order; a shared-tier slice fits the 232,448 B a
    block may have; an L2-tier pass adds into at most L2_TABLE_BYTES."""
    p = th.plan(n_bins, 50_000_000)
    assert p.ranges[0][0] == 0 and p.ranges[-1][1] == n_bins
    for (_, hi), (lo, _) in zip(p.ranges, p.ranges[1:]):
        assert hi == lo
    assert all(lo < hi for lo, hi in p.ranges)
    if p.tier == "shared":
        assert len(p.ranges) == 1
        assert 1 <= p.slices <= th.SHARED_MAX_SLICES
        assert p.shared_bytes <= th.SHARED_BYTES == 232_448
        assert p.slices * p.shared_bytes >= 4 * n_bins
    else:
        assert p.tier == "l2" and p.shared_bytes == 0
        assert all(4 * (hi - lo) <= th.L2_TABLE_BYTES for lo, hi in p.ranges)


@pytest.mark.parametrize("n_bins, tier, slices, passes", [
    (128, "shared", 1, 1), (384, "shared", 1, 1), (4 ** 6, "shared", 1, 1),
    (4 ** 7, "shared", 1, 1), (58_112, "shared", 1, 1),
    (4 ** 8, "shared", 2, 1), (4 ** 9, "shared", 5, 1),
    (4 ** 10, "l2", 0, 1), (4 ** 12, "l2", 0, 3)])
def test_plan_takes_the_measured_tier(n_bins, tier, slices, passes):
    p = th.plan(n_bins, 50_000_000)
    assert (p.tier, p.slices, len(p.ranges)) == (tier, slices, passes)


@pytest.mark.parametrize("n, passes", [(1, 1), (6125, 1), (786_432, 1),
                                       (786_433, 3), (2_000_000, 3)])
def test_plan_short_input_takes_one_pass(n, passes):
    """An input too short to touch more of the 4**12 table than L2 keeps
    is counted in one pass."""
    assert len(th.plan(4 ** 12, n).ranges) == passes


@pytest.mark.parametrize("n_bins", SIZES)
def test_bin_range_passes_sum_to_the_whole(n_bins):
    """What the kernels do per launch, emulated with the plain version:
    each pass (and each slice of a sliced pass) counts only the ids of its
    bin range into its part of the table; together they are the whole."""
    ids, inc = _inputs(30_000, n_bins, seed=n_bins % 89)
    t_ids, t_inc = torch.from_numpy(ids), torch.from_numpy(inc)
    p = th.plan(n_bins, 50_000_000)
    ranges = p.ranges
    if p.tier == "shared":
        ranges = th._tiles(n_bins, p.slices)
        assert len(ranges) == p.slices
    out = torch.zeros(n_bins, dtype=torch.int32)
    for lo, hi in ranges:
        in_range = (t_ids >= lo) & (t_ids < hi)
        part = th.histogram_plain(t_ids - lo, t_inc * in_range, hi - lo)
        out[lo:hi] += part
    np.testing.assert_array_equal(
        out.numpy(), _ref(pallas_hist.histogram, ids, inc, n_bins))


@pytest.mark.parametrize("n_bins", [384, 4 ** 6, 4 ** 8, 4 ** 10])
def test_out_accumulates(n_bins):
    """``out=`` adds into a non-zero table: two calls into one table equal
    two separate calls summed and the reference on the joined input."""
    ids_a, inc_a = _inputs(9_000, n_bins, seed=11)
    ids_b, inc_b = _inputs(7_001, n_bins, seed=12)
    a = (torch.from_numpy(ids_a), torch.from_numpy(inc_a))
    b = (torch.from_numpy(ids_b), torch.from_numpy(inc_b))
    run = th.histogram(*a, n_bins)
    before = run.clone()
    assert th.histogram(*b, n_bins, out=run) is run
    np.testing.assert_array_equal(
        run.numpy(), (before + th.histogram(*b, n_bins)).numpy())
    np.testing.assert_array_equal(
        run.numpy(),
        _ref(pallas_hist.histogram, np.concatenate([ids_a, ids_b]),
             np.concatenate([inc_a, inc_b]), n_bins))
    plain = th.histogram_plain(*a, n_bins)
    assert th.histogram_plain(*b, n_bins, out=plain) is plain
    np.testing.assert_array_equal(plain.numpy(), run.numpy())


@pytest.mark.parametrize("n_bins", [384, 4 ** 8])
@pytest.mark.parametrize("edge", tb.EDGE_NAMES)
def test_shared_edge_inputs_match_reference(edge, n_bins):
    """The edge inputs that the card's tests and chip_smoke.py hand the
    kernels, here through the plain version against the reference
    dispatcher (the all-in-one-bin input at 2**18 instead of 2**24)."""
    ids, inc = tb.edge_tensors(edge, n_bins, "cpu", many=1 << 18)
    assert ids.shape == inc.shape
    ids_np, inc_np = ids.numpy(), (inc.numpy() != 0).astype(np.int32)
    got = th.histogram(ids, inc, n_bins).numpy()
    ok = (inc_np != 0) & (ids_np >= 0) & (ids_np < n_bins)
    np.testing.assert_array_equal(
        got, np.bincount(ids_np[ok], minlength=n_bins))
    # the reference's scatter drops a counted id >= n_bins too, but wraps
    # a negative one to the table's end: those it is not asked about
    np.testing.assert_array_equal(
        got, _ref(pallas_hist.histogram, ids_np,
                  inc_np * (ids_np >= 0), n_bins))
