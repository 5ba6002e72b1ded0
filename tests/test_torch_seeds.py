"""The device engine's seed selection on the CPU
(peng_motif_tpu_torch/engine.py, ``count.seeds``).

The seeds read the stats program's z and expected on every table, and
they must be the host's (native.bg_prob_table_native_fn for bgp,
native.base_stats_native for expected and z) bit for bit, NaN at the
same places, on MafK_100seqs's background at -w 4 to 12, with
background orders 0 to 3, on both strands and on the plus strand.
Where the host sorts the whole table it fetches them; elsewhere the
z-sort's large partitions run on the device (ops/seed_sort.py), and the
prefix the seed walk reads must be the native zscore_sort_prefix's
element for element: on tables made to stress it, on MafK_100seqs's z
tables at -w 9 to 12, and in whole jobs, whose seeds and seed tables
must be those of the whole-table host sort.  The same checks on the card
are in tests/test_torch_gpu.py
(test_seeds_bgp_from_the_card_is_the_host_fold,
test_seeds_z_and_prefix_from_the_card).
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from conftest import GOLDEN_DIR

from peng_motif_tpu_torch import cli, engine, pipeline
from peng_motif_tpu_torch.io.fasta import load_sequence_set
from peng_motif_tpu_torch.models.background import BackgroundModel
from peng_motif_tpu_torch.native import (
    base_stats_native,
    bg_prob_table_native_fn,
    count_rows_exact_native,
    seed_walk_prefix_native,
    select_patterns_walk_native,
    zscore_sort_prefix_indices,
)
from peng_motif_tpu_torch.ops import hybrid, seed_sort
from peng_motif_tpu_torch.utils.logging_utils import PhaseTimer

MAFK = os.path.join(GOLDEN_DIR, "MafK_100seqs.fasta")


@pytest.fixture(scope="module")
def mafk_v():
    """The MafK_100seqs background's conditionals, by order."""
    seqs = load_sequence_set(MAFK).sequences
    return {k: BackgroundModel(seqs, order=k).v for k in range(4)}


def _host_fold(v, W, order, both):
    return bg_prob_table_native_fn(
        [np.asarray(x, dtype=np.float32) for x in v[: order + 1]], W, order,
        both)


def _nan_table(v, counts):
    """The NaN table of test_tables_the_host_sorts_whole: no G or T in
    the order-0 background (bgp 0 beside them), and zero counts there in
    places (z = 0 / 0)."""
    v = [np.asarray(x, dtype=np.float32) for x in v]
    v[0] = np.float32([0.5, 0.5, 0.0, 0.0])
    counts = counts.copy()
    counts[::7] = 0
    return v, counts


def _assert_same_bits(got, want, name):
    assert got.dtype == want.dtype == np.float32, name
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan, err_msg=name)
    np.testing.assert_array_equal(got[~nan].view(np.uint32),
                                  want[~nan].view(np.uint32), err_msg=name)


@pytest.mark.parametrize("both", [True, False], ids=["both", "plus"])
@pytest.mark.parametrize("order", range(4))
@pytest.mark.parametrize("W", range(4, 13))
def test_seeds_bgp_is_the_host_fold(W, order, both, mafk_v):
    """The stats program's bgp is the host fold, and its expected and z
    are base_stats_native's over that bgp, bit for bit: on a nonzero
    table, and on the NaN table."""
    k = min(W - 1, order)   # the engine's current_k
    v = mafk_v[order][: k + 1]
    counts = np.random.default_rng(W).integers(0, 40, 4 ** W).astype(
        np.int32)
    none = np.zeros(0, dtype=np.int32)
    for name, (vt, ct) in (("nonzero", (v, counts)),
                           ("nan", _nan_table(v, counts))):
        state = engine.resident_state(ct, 12_345, none, none, vt, "cpu")
        st = engine.stats_program(state, W, k, k, both)
        got = st["bgp"].numpy()
        want = _host_fold(vt, W, k, both)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32), err_msg=name)
        expected, z = base_stats_native(ct, want, 12_345)
        _assert_same_bits(st["expected"].numpy(), expected, name)
        _assert_same_bits(st["z"].numpy(), z, name)
        assert np.isnan(z).any() == (name == "nan")


@pytest.mark.parametrize("strand", ["BOTH", "PLUS"])
def test_seed_selection_reads_the_fetched_bgp(strand, monkeypatch,
                                              tmp_path, mafk_v):
    """A whole -w 8 job (the whole-table host sort): the prefix its
    seeds were walked over is base_stats_native + the native z-sort over
    the job's own table and the host fold of its background, and the
    seeds' spans are recorded."""
    seen = {}
    real_phase, real_prefix = engine._count_phase, engine._seed_prefix

    def count_phase(*a, **k):
        out = real_phase(*a, **k)
        seen.update(counts=out[0].copy(), ltot=out[1])
        return out

    def seed_prefix(st, zthr):
        seen.update(zthr=zthr, prefix=real_prefix(st, zthr))
        return seen["prefix"]

    monkeypatch.setattr(engine, "_count_phase", count_phase)
    monkeypatch.setattr(engine, "_seed_prefix", seed_prefix)
    err = io.StringIO()
    argv = [MAFK, "-w", "8", "--strand", strand, "--device", "cpu",
            "--engine", "tpu", "-o", str(tmp_path / "o.meme"), "--timing"]
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        assert cli.main(argv) == 0
    bgp = _host_fold(mafk_v[2], 8, 2, strand == "BOTH")
    expected, z = base_stats_native(seen["counts"], bgp, seen["ltot"])
    want, _keep = _native_prefix(z, seen["zthr"])
    prefix = seen["prefix"]
    assert len(want) > 1
    np.testing.assert_array_equal(prefix.ids, want)
    np.testing.assert_array_equal(prefix.z.view(np.uint32),
                                  z[want].view(np.uint32))
    np.testing.assert_array_equal(prefix.expected.view(np.uint32),
                                  expected[want].view(np.uint32))
    for part in ("fetch", "sort", "walk"):
        assert f"[TIMING] count.seeds.{part}: " in err.getvalue(), part


# -- the seed z-sort with its large partitions on the device ------------------
# (ops/seed_sort.py): on the CPU the same torch code runs, so its prefix is
# held here to the native zscore_sort_prefix, element for element


def _native_prefix(z, thr):
    keep = int(np.count_nonzero(~(z < np.float32(thr))))
    return zscore_sort_prefix_indices(z, thr)[: keep + 1], keep


def _device_prefix(z, thr, expected=None):
    """(the device path's prefix, its partitions), or None where it
    leaves the table to the host."""
    zt = torch.from_numpy(np.ascontiguousarray(z, dtype=np.float32))
    keep = seed_sort.device_keep(zt, thr)
    if keep is None:
        return None
    with PhaseTimer().activate() as rec:
        got = seed_sort.sorted_prefix(
            zt, zt if expected is None else torch.from_numpy(expected), keep)
    return got, rec.counters["seeds.card_partitions"]


def _table(kind, n, rng):
    """(z, thr) of one kind of table."""
    if kind == "distinct":
        z = rng.permutation(n).astype(np.float32) / 64
        return z, float(np.quantile(z, 0.95))
    if kind == "rc_pairs":
        # on both strands every k-mer's z is its reverse complement's
        ids = np.arange(n)
        rc = np.zeros(n, dtype=np.int64)
        w = (n.bit_length() - 1) // 2
        for p in range(w):
            rc |= (3 - ((ids >> (2 * p)) & 3)) << (2 * (w - 1 - p))
        z = np.round(rng.gamma(1.0, 2.0, n), 1).astype(np.float32)
        z = np.maximum(z, z[rc])
        return z, 9.0
    if kind == "three_values":
        return rng.choice(np.float32([-1.5, 0.25, 4.0]), n), 1.0
    if kind == "all_equal":
        return np.full(n, 2.5, dtype=np.float32), 3.0
    if kind == "ascending":
        return np.arange(n, dtype=np.float32) / 100, 0.95 * n / 100
    if kind == "descending":
        return np.arange(n, dtype=np.float32)[::-1] / 100, 0.95 * n / 100
    z = rng.permutation(n).astype(np.float32)
    if kind == "keep_0":
        return z, float(n)
    if kind == "keep_n_minus_33":
        return z, 33.0
    raise ValueError(kind)


KINDS = ("distinct", "rc_pairs", "three_values", "all_equal", "ascending",
         "descending", "keep_0", "keep_n_minus_33")


@pytest.mark.parametrize("host_range", ["fitted", 64])
@pytest.mark.parametrize("kind", KINDS)
def test_device_prefix_is_the_native_prefix(kind, host_range, monkeypatch):
    """Tables of 4**9 entries with the fitted host range (the device's
    part is the first few partitions), and of 4**7 with a host range of
    64 (nearly every partition on the device)."""
    n = 4 ** 9
    if host_range != "fitted":
        monkeypatch.setattr(seed_sort, "HOST_RANGE", host_range)
        n = 4 ** 7
    z, thr = _table(kind, n, np.random.default_rng(17))
    want, keep = _native_prefix(z, thr)
    if kind == "keep_0":
        assert keep == 0
    if kind == "keep_n_minus_33":
        assert keep == n - 33
    expected = np.random.default_rng(5).random(n, dtype=np.float32)
    (got, parts) = _device_prefix(z, thr, expected)
    assert parts >= 1
    np.testing.assert_array_equal(got.ids, want)
    np.testing.assert_array_equal(got.z.view(np.uint32),
                                  z[want].view(np.uint32))
    np.testing.assert_array_equal(got.expected, expected[want])


def _depth_killer(n, rng):
    """z of ``n`` entries on which each partition of the left spine takes
    a pivot among the range's least values, so the range shrinks by two a
    partition and its depth budget runs out while it is long.  Built as
    McIlroy's adversary: values are fixed (counting up from the least) only
    when they become pivot candidates; every other entry stays larger than
    all of them, and gets its value at the end."""
    z = torch.full((n,), float("inf"))
    ids = torch.arange(n, dtype=torch.int32)
    val = np.full(n, np.inf, dtype=np.float32)
    nxt, first, last = 0, 0, n
    for _ in range(2 * (n.bit_length() - 1)):
        for p in (first + 1, first + (last - first) // 2, last - 1):
            i = int(ids[p])
            if np.isinf(val[i]):
                val[i] = z[p] = nxt
                nxt += 1
        last = seed_sort._partition(z, ids, first, last)
    rest = np.isinf(val)
    val[rest] = nxt + rng.permutation(int(rest.sum()))
    return val


def test_depth_budget_spent_on_a_long_range():
    """A range still longer than the host range when its depth budget runs
    out goes to the host with budget 0 (std::__partial_sort there), and
    the prefix is still the native one."""
    n = 2 * seed_sort.HOST_RANGE + 4096
    z = _depth_killer(n, np.random.default_rng(3))
    thr = float(np.median(z))
    zt = torch.from_numpy(z.copy())
    left, parts = seed_sort.device_partitions(
        zt, torch.arange(n, dtype=torch.int32), n // 2)
    assert parts == 2 * (n.bit_length() - 1)
    assert any(d == 0 and b - a > seed_sort.HOST_RANGE for a, b, d in left)
    want, _ = _native_prefix(z, thr)
    (got, _parts) = _device_prefix(z, thr)
    np.testing.assert_array_equal(got.ids, want)


@pytest.mark.parametrize("case", ["nan", "keep_n_minus_32", "small"])
def test_tables_the_host_sorts_whole(case, mafk_v):
    """A NaN z-score, fewer than 33 entries below the threshold, or a
    table of at most the host range: the seeds take the whole-table host
    sort, the device runs no partition, and the counter reads 0."""
    W = 8 if case == "small" else 9
    n = 4 ** W
    rng = np.random.default_rng(11)
    counts = rng.integers(0, 40, n).astype(np.int32)
    v = [np.asarray(x, dtype=np.float32) for x in mafk_v[2]]
    if case == "nan":
        v, counts = _nan_table(v, counts)
    none = np.zeros(0, dtype=np.int32)
    state = engine.resident_state(counts, 40_000, none, none, v, "cpu")
    st = engine.stats_program(state, W, 2, 2, False)
    z = st["z"].numpy()
    thr = 3.0
    if case == "nan":
        assert np.isnan(z).any()
    if case == "keep_n_minus_32":
        thr = float(np.sort(z)[32])   # 32 entries below it, no ties there
        assert np.count_nonzero(z < np.float32(thr)) == 32
    assert seed_sort.device_keep(st["z"], thr) is None
    with PhaseTimer().activate() as rec:
        got = engine._seed_prefix(st, thr)
    assert rec.counters["seeds.card_partitions"] == 0
    assert rec.calls("fetch") == rec.calls("sort") == 1
    want, _ = _native_prefix(z, thr)
    np.testing.assert_array_equal(got.ids, want)
    np.testing.assert_array_equal(got.z.view(np.uint32),
                                  z[want].view(np.uint32))
    np.testing.assert_array_equal(
        got.expected.view(np.uint32),
        st["expected"].numpy()[want].view(np.uint32))


# -- MafK_100seqs jobs through the CLI, to their seeds ------------------------


class _Stop(Exception):
    """Ends a job after its seed table, where the climb would begin."""


class _Kept(PhaseTimer):
    made: list = []

    def __init__(self):
        super().__init__()
        _Kept.made.append(self)


def _job_to_seeds(W, strand, host_range=None):
    """A MafK_100seqs job on the device engine up to its seed table (the
    count forced onto the host, as the w12 cell counts): its stdout,
    seeds, recorder, and what the seed selection read and made."""
    seen = {}
    real = engine._seed_prefix

    def seed_prefix(st, zthr):
        seen.update(z=st["z"].numpy().copy(),
                    expected=st["expected"].numpy().copy(), zthr=zthr)
        seen["prefix"] = real(st, zthr)
        return seen["prefix"]

    def run_walks(counts, expected, bgp, seeds, *a, **k):
        seen["seeds"] = list(seeds)
        raise _Stop

    def process_gpu(peng, params):
        try:
            return real_gpu(peng, params)
        except _Stop:
            # the job's stdout so far, which the pipeline buffers
            seen["stdout"] = peng.out.getvalue()
            raise

    real_gpu = pipeline.process_gpu
    argv = [MAFK, "-w", str(W), "--strand", strand, "--device", "cpu",
            "--engine", "tpu", "-o", os.devnull]
    _Kept.made.clear()
    with pytest.MonkeyPatch.context() as m:
        m.setattr(hybrid, "count_on_host", lambda *a: True)
        m.setattr(engine, "_seed_prefix", seed_prefix)
        m.setattr(engine, "run_walks", run_walks)
        m.setattr(pipeline, "process_gpu", process_gpu)
        m.setattr(cli, "PhaseTimer", _Kept)
        if host_range is not None:
            m.setattr(seed_sort, "HOST_RANGE", host_range)
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()), \
                pytest.raises(_Stop):
            cli.main(argv)
    (seen["recorder"],) = _Kept.made
    return seen


@pytest.fixture(scope="module")
def mafk_tables(mafk_v):
    """``tables(W, both)``: MafK_100seqs's count table at W (the host
    count), and z and expected from the stats program at background
    order 2, as numpy."""
    seqs = load_sequence_set(MAFK).sequences
    codes = np.zeros((len(seqs), max(len(x) for x in seqs) + 3), np.uint8)
    for i, x in enumerate(seqs):
        codes[i, : len(x)] = x
    cache = {}

    def tables(W, both):
        if (W, both) not in cache:
            counts, ltot = count_rows_exact_native(codes, W, both)
            none = np.zeros(0, dtype=np.int32)
            state = engine.resident_state(counts, ltot, none, none,
                                          mafk_v[2], "cpu")
            st = engine.stats_program(state, W, 2, 2, both)
            cache[W, both] = (counts, ltot, st["z"].numpy(),
                              st["expected"].numpy())
        return cache[W, both]
    return tables


@pytest.mark.parametrize("both", [True, False], ids=["both", "plus"])
@pytest.mark.parametrize("W", range(9, 13))
def test_device_prefix_on_mafk_z_tables(W, both, mafk_tables):
    """MafK_100seqs's z tables at the MafK default threshold: the
    device path's prefix is the native one, with the z and expected
    counts at its ids."""
    _counts, _ltot, z, expected = mafk_tables(W, both)
    want, _keep = _native_prefix(z, 10.0)
    (got, parts) = _device_prefix(z, 10.0, expected)
    assert parts >= 1
    np.testing.assert_array_equal(got.ids, want)
    np.testing.assert_array_equal(got.z.view(np.uint32),
                                  z[want].view(np.uint32))
    np.testing.assert_array_equal(got.expected.view(np.uint32),
                                  expected[want].view(np.uint32))


@pytest.mark.parametrize("both", [True, False], ids=["both", "plus"])
@pytest.mark.parametrize("W", range(9, 13))
@pytest.mark.parametrize("zthr,count_thr,neighbors", [
    (10.0, 1, True), (4.0, 5, False), (3.0, 1, True)])
def test_prefix_walk_is_the_table_walk(W, both, zthr, count_thr, neighbors,
                                       mafk_tables):
    """The walk over the sorted prefix (seedsort.cpp) selects what the
    walk over the whole tables (pengnative.cpp select_patterns_walk)
    selects, on MafK_100seqs's tables."""
    counts, _ltot, z, _expected = mafk_tables(W, both)
    order = zscore_sort_prefix_indices(z, zthr)
    want = select_patterns_walk_native(order, z, counts, W, zthr, count_thr,
                                       not both, neighbors)
    ids, _keep = _native_prefix(z, zthr)
    pos = seed_walk_prefix_native(ids, z[ids], counts[ids], W, zthr,
                                  count_thr, not both, neighbors)
    np.testing.assert_array_equal(ids[pos], want)
    assert len(want)


# the CLI takes even widths only (cli.py)
@pytest.mark.parametrize("strand", ["BOTH", "PLUS"])
@pytest.mark.parametrize("W", [10, 12])
def test_job_seeds_are_the_host_sorts(W, strand):
    """A job's seeds and printed seed table are byte for byte those of
    the same job with the whole table sorted on the host, and the device
    ran partitions only in the first; the prefix it walked is the native
    one of its own z table."""
    job = _job_to_seeds(W, strand)
    want, _keep = _native_prefix(job["z"], job["zthr"])
    np.testing.assert_array_equal(job["prefix"].ids, want)
    host = _job_to_seeds(W, strand, host_range=4 ** 13)
    assert host["recorder"].counters["seeds.card_partitions"] == 0
    assert job["recorder"].counters["seeds.card_partitions"] > 0
    assert host["recorder"].calls("count.seeds.fetch") == 1
    assert job["recorder"].calls("count.seeds.fetch") == 0
    assert job["seeds"] == host["seeds"] and job["seeds"]
    assert job["stdout"] == host["stdout"]
    assert "zscore" in job["stdout"]


@pytest.mark.parametrize("W", [6, 8])
def test_small_tables_count_no_device_partition(W, tmp_path):
    """At W <= 8 the table is within the host range: a whole job sorts it
    on the host and reports the counter as 0."""
    err = io.StringIO()
    argv = [MAFK, "-w", str(W), "--device", "cpu", "--engine", "tpu", "-o",
            str(tmp_path / "o.meme"), "--timing"]
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        assert cli.main(argv) == 0
    assert "[COUNT] seeds.card_partitions: 0\n" in err.getvalue()
    assert "[TIMING] count.seeds.fetch: " in err.getvalue()
