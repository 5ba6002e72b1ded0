"""The port's hybrid host+device co-count (ops/hybrid.py and its wiring
in engine._count_phase): the planner's split must never change any
output — the count table, ltot and the background model are
per-sequence additive, so every fraction yields byte-identical results
on one device.  Twins of tests/test_hybrid.py: the planner's edges (its
constants injected through the environment overrides or set on the
module, so no test depends on the measured defaults beyond the two sides
of their crossover), the split, the host rows, the host share
against a full scan, error surfacing, the engine's output under forced
splits on uniform and ragged-with-N corpora (byte-identical to its own
pure-device output; within the ENGINE_CASES tolerance, 5e-6 + 1e-6
relative, of the reference engine under the same forced fraction), and a
host-share bin above 65,535.
"""

import os

import numpy as np
import pytest
import torch

from conftest import GOLDEN_DIR
from test_torch_engine import _assert_within_tol

from peng_motif_tpu.cli import main as reference_main
from peng_motif_tpu.ops import hybrid as jhy
from peng_motif_tpu_torch import engine
from peng_motif_tpu_torch.cli import main
from peng_motif_tpu_torch.models.background import count_kmers
from peng_motif_tpu_torch.native import count_rows_exact_native
from peng_motif_tpu_torch.ops import histogram as th
from peng_motif_tpu_torch.ops import hybrid as hy
from peng_motif_tpu_torch.utils.logging_utils import PhaseTimer

RATES = {"PENG_WIRE_BASES_S": "8e8", "PENG_HOST_SCAN_BASES_S": "2e8",
         "PENG_DEVICE_LATENCY_S": "0.02"}


@pytest.fixture
def rates(monkeypatch):
    """A cost model of the test's own: device share 800 Mbases/s, host
    share 200 Mbases/s, 20 ms of fixed device cost."""
    monkeypatch.delenv("PENG_HYBRID_DEVICE_FRAC", raising=False)
    for k, v in RATES.items():
        monkeypatch.setenv(k, v)


def _run(argv, out, monkeypatch, frac=None, fn=main):
    if frac is None:
        monkeypatch.delenv("PENG_HYBRID_DEVICE_FRAC", raising=False)
    else:
        monkeypatch.setenv("PENG_HYBRID_DEVICE_FRAC", str(frac))
    assert fn(argv + ["-o", out]) == 0
    with open(out, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# planner unit behavior
# ---------------------------------------------------------------------------


def test_plan_tiny_corpus_host_only(rates):
    # 1 Mbase: the host scan's 5 ms is less than the device share's fixed
    # 20 ms -> keep everything on the host
    assert hy.plan_device_fraction(1_000_000) == 0.0
    assert hy.plan_device_fraction(0) == 0.0
    # the crossover: B/h == lat at 4 Mbases
    assert hy.plan_device_fraction(4_000_000) == 0.0
    assert hy.plan_device_fraction(4_100_000) > 0.0


def test_plan_large_corpus_splits(rates, monkeypatch):
    f = hy.plan_device_fraction(51_200_000)
    # f* = (B/h - lat) / (B/d + B/h) = (0.256 - 0.02) / (0.064 + 0.256)
    assert f == pytest.approx(0.7375)
    # the device share grows toward the equal-finish split d/(d+h)
    f_big = hy.plan_device_fraction(1_000_000_000)
    assert f < f_big < 0.8
    # a slower device share keeps more of the corpus on the host
    monkeypatch.setenv("PENG_WIRE_BASES_S", "1e8")
    assert hy.plan_device_fraction(51_200_000) < f
    # the reference's planner, its device rate 1/(1/wire + 1/kernel)
    # given as one number: the same formula
    monkeypatch.setenv("PENG_WIRE_BASES_S", "1e30")
    want = jhy.plan_device_fraction(51_200_000, 10)
    monkeypatch.setenv("PENG_WIRE_BASES_S", "115e6")  # its 4**10 kernel rate
    assert hy.plan_device_fraction(51_200_000, 10) == pytest.approx(want)


def test_plan_degenerate_rates(rates, monkeypatch):
    monkeypatch.setenv("PENG_HOST_SCAN_BASES_S", "0")
    assert hy.plan_device_fraction(10 ** 7) == 1.0
    monkeypatch.setenv("PENG_WIRE_BASES_S", "0")
    assert hy.plan_device_fraction(10 ** 7) == 0.0
    monkeypatch.setenv("PENG_WIRE_BASES_S", "not a number")
    monkeypatch.setenv("PENG_HOST_SCAN_BASES_S", "also not")
    assert 0.0 <= hy.plan_device_fraction(10 ** 7) <= 1.0  # the defaults


def test_plan_defaults_pick_an_end(monkeypatch):
    """Without a host rate from the environment the planner compares the
    two ends, B/h against B/d + lat, and answers 0.0 or 1.0: the measured
    host scan adds no rate beside a device share, so no split is planned.
    A host rate given through the environment brings the split back."""
    for k in list(RATES) + ["PENG_HYBRID_DEVICE_FRAC"]:
        monkeypatch.delenv(k, raising=False)
    # the shipped defaults: a default run on each side of the crossover
    # (a small corpus at W = 12 pays the device count's fixed cost for
    # nothing; a large one at W = 10 belongs on the card)
    assert hy.plan_device_fraction(20_000, 12) == 0.0
    assert hy.plan_device_fraction(51_200_000, 10) == 1.0
    for W in (6, 8, 10, 12):
        for bases in (1_000, 10 ** 6, 51_200_000, 10 ** 9):
            assert hy.plan_device_fraction(bases, W) in (0.0, 1.0)
        assert hy.plan_device_fraction(10 ** 10, W) == 1.0
    # a cost model of the test's own, by width (W <= 8, <= 10, wider)
    monkeypatch.setattr(hy, "_DEVICE_BASES_S", (8e8, 8e8, 1e8))
    monkeypatch.setattr(hy, "_HOST_BASES_S", (2e8, 2e8, 5e7))
    monkeypatch.setattr(hy, "_DEVICE_LATENCY_S", (0.02, 0.02, 0.7))
    # B/2e8 < B/8e8 + 0.02 below 5.33 Mbases
    assert hy.plan_device_fraction(5_300_000, 8) == 0.0
    assert hy.plan_device_fraction(5_400_000, 8) == 1.0
    assert hy.plan_device_fraction(5_400_000, 10) == 1.0
    # B/5e7 < B/1e8 + 0.7 below 70 Mbases
    assert hy.plan_device_fraction(51_200_000, 12) == 0.0
    assert hy.plan_device_fraction(80_000_000, 12) == 1.0
    # the other two overrides move the crossover of the two ends
    monkeypatch.setenv("PENG_DEVICE_LATENCY_S", "0.002")
    assert hy.plan_device_fraction(5_300_000, 8) == 1.0
    monkeypatch.setenv("PENG_WIRE_BASES_S", "1e8")
    assert hy.plan_device_fraction(5_300_000, 8) == 0.0
    # a stated host rate: the formula's split and its crossover
    monkeypatch.setenv("PENG_HOST_SCAN_BASES_S", "1e8")
    for W in (6, 8, 10, 12):
        f = hy.plan_device_fraction(51_200_000, W)
        assert 0.0 < f < 1.0
        assert hy.plan_device_fraction(10 ** 9, W) > f
        assert hy.plan_device_fraction(1_000, W) == 0.0


def test_plan_env_override(monkeypatch):
    monkeypatch.setenv("PENG_HYBRID_DEVICE_FRAC", "1")
    assert hy.plan_device_fraction(10) == 1.0
    monkeypatch.setenv("PENG_HYBRID_DEVICE_FRAC", "0.25")
    assert hy.plan_device_fraction(10 ** 9) == 0.25
    monkeypatch.setenv("PENG_HYBRID_DEVICE_FRAC", "7")  # clipped
    assert hy.plan_device_fraction(10) == 1.0
    monkeypatch.setenv("PENG_HYBRID_DEVICE_FRAC", "-3")
    assert hy.plan_device_fraction(10 ** 9) == 0.0


def test_split_index_edges():
    lens = np.array([10, 20, 30, 40], dtype=np.int64)
    assert hy.split_index(lens, 0.0) == (0, 0)
    assert hy.split_index(lens, 1.0) == (4, 100)
    ja, off = hy.split_index(lens, 0.5)
    assert off == int(lens[:ja].sum())
    assert lens[:ja].sum() >= 50 and lens[: ja - 1].sum() < 50
    assert hy.split_index(np.zeros(0, np.int64), 0.5) == (0, 0)
    for frac in (0.0, 0.01, 0.3, 0.5, 0.99, 1.0):
        assert hy.split_index(lens, frac) == jhy.split_index(lens, frac)


def test_host_rows_uniform_and_ragged():
    rng = np.random.default_rng(0)
    seqs = [rng.integers(0, 5, size=12).astype(np.uint8) for _ in range(5)]
    flat = np.concatenate(seqs)
    lens = np.full(5, 12, dtype=np.int64)
    rows = hy._host_rows(seqs, lens, flat, 0)
    assert rows.base is flat or rows.flags["OWNDATA"] is False  # view
    np.testing.assert_array_equal(rows, np.stack(seqs))
    # ragged + offset: suffix starting at sequence 2
    seqs_r = [rng.integers(1, 5, size=n).astype(np.uint8)
              for n in (7, 3, 9, 4)]
    flat_r = np.concatenate(seqs_r)
    rows_r = hy._host_rows(
        seqs_r[2:], np.array([9, 4], np.int64), flat_r, 10)
    want = np.zeros((2, 9), np.uint8)
    want[0] = seqs_r[2]
    want[1, :4] = seqs_r[3]
    np.testing.assert_array_equal(rows_r, want)
    np.testing.assert_array_equal(rows_r, jhy._host_rows(
        seqs_r[2:], np.array([9, 4], np.int64), flat_r, 10))
    # no flat buffer: built from the sequence list
    rows_n = hy._host_rows(seqs_r[2:], np.array([9, 4], np.int64), None, 0)
    np.testing.assert_array_equal(rows_n, want)
    assert hy._host_rows([], np.zeros(0, np.int64), None, 0).shape == (0, 1)


def test_host_share_counts_match_full_scan():
    """Device-share + host-share tables must sum to the full-corpus
    table (per-sequence additivity), including bg counts."""
    rng = np.random.default_rng(3)
    seqs = [rng.integers(0, 5, size=rng.integers(20, 90)).astype(np.uint8)
            for _ in range(40)]
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    flat = np.concatenate(seqs)
    full_tab, full_ltot = count_rows_exact_native(
        hy._host_rows(seqs, lens, flat, 0), 6, True)
    ja, off = hy.split_index(lens, 0.5)
    a_tab, a_ltot = count_rows_exact_native(
        hy._host_rows(seqs[:ja], lens[:ja], flat[:off], 0), 6, True)
    with PhaseTimer().activate() as recorder:
        share = hy.start_host_share(seqs[ja:], lens[ja:], flat, off, 6,
                                    True, bg_order=2)
        b_tab, b_ltot, bg_b = share.join()
    # the share's own thread is timed as the recorder's span host_thread
    (thread_span,) = [s for s in recorder.spans if s.path == "host_thread"]
    assert thread_span.end_ns > thread_span.start_ns
    np.testing.assert_array_equal(a_tab + b_tab, full_tab)
    assert a_ltot + b_ltot == full_ltot
    bg_full = count_kmers(seqs, 2)
    bg_a = count_kmers(seqs[:ja], 2)
    for k in range(3):
        np.testing.assert_array_equal(bg_a[k] + bg_b[k], bg_full[k])
    # the reference package's host share, on the same suffix
    r_tab, r_ltot, r_bg = jhy.start_host_share(
        seqs[ja:], lens[ja:], flat, off, 6, True, bg_order=2).join()
    np.testing.assert_array_equal(b_tab, r_tab)
    assert b_ltot == r_ltot
    for k in range(3):
        np.testing.assert_array_equal(bg_b[k], r_bg[k])
    # no background scan unless asked for
    assert hy.start_host_share(seqs[ja:], lens[ja:], flat, off, 6,
                               True).join()[2] is None


def test_host_share_error_surfaces():
    share = hy.start_host_share(
        [np.array([1, 2, 3], np.uint8)], np.array([3], np.int64),
        None, 0, -1, True)  # invalid W -> the scan must fail loudly
    with pytest.raises(Exception):
        share.join()


def test_failing_host_share_fails_the_run(tmp_path, monkeypatch):
    """A host-share exception surfaces from join() and fails the run: no
    fallback to a pure-device count, none to the exact engine."""
    class Boom(RuntimeError):
        pass

    def broken(*a, **k):
        raise Boom("host share broke")

    monkeypatch.setattr(hy, "count_rows_exact_native", broken)
    monkeypatch.setenv("PENG_HYBRID_DEVICE_FRAC", "0.5")
    out = tmp_path / "o.meme"
    with pytest.raises(Boom):
        main([os.path.join(GOLDEN_DIR, "MafK_100seqs.fasta"), "-w", "8",
              "--device", "cpu", "--engine", "tpu", "-o", str(out)])
    assert not out.exists()


# ---------------------------------------------------------------------------
# end-to-end: every fraction yields identical output
# ---------------------------------------------------------------------------


def _write_corpus(path, rng, n, lo, hi, with_n=False):
    letters = np.frombuffer(b"NACGT", dtype=np.uint8)
    with open(path, "wb") as f:
        for i in range(n):
            ln = int(rng.integers(lo, hi + 1))
            codes = rng.integers(1, 5, size=ln)
            if with_n and i % 7 == 0:
                p = int(rng.integers(0, max(ln - 5, 1)))
                codes[p: p + 4] = 0
            f.write(b">s%d\n" % i)
            f.write(letters[codes].tobytes())
            f.write(b"\n")


class _Phase:
    """Records what engine._count_phase returned in each run."""

    def __init__(self, monkeypatch):
        self.runs = []
        real = engine._count_phase

        def count_phase(*a, **k):
            out = real(*a, **k)
            self.runs.append(out)
            return out

        monkeypatch.setattr(engine, "_count_phase", count_phase)


FRACS = (1, 0.7, 0.3, 0)


@pytest.mark.parametrize("ragged_n", [False, True],
                         ids=["uniform", "ragged_n"])
def test_engine_output_invariant_under_split(tmp_path, monkeypatch,
                                             ragged_n):
    """frac 1 / 0.7 / 0.3 / 0 byte-identical on uniform and ragged+N
    corpora (the same device programs on every run, so the invariance is
    exact), the count phase's tables equal, and each run within the
    engine tolerance of the reference engine under the same fraction."""
    rng = np.random.default_rng(11 if ragged_n else 5)
    data = str(tmp_path / "c.fasta")
    if ragged_n:
        _write_corpus(data, rng, 120, 60, 140, with_n=True)
    else:
        _write_corpus(data, rng, 150, 100, 100)
    argv = [data, "-w", "6", "--engine", "tpu"]
    rec = _Phase(monkeypatch)
    outs, refs = {}, {}
    for frac in FRACS:
        outs[frac] = _run(argv + ["--device", "cpu"],
                          str(tmp_path / f"o{frac}.meme"), monkeypatch, frac)
        assert engine.LAST_HYBRID_FRAC == float(frac)
        assert engine.LAST_ENGINE_USED == "cpu"
        refs[frac] = _run(argv, str(tmp_path / f"r{frac}.meme"),
                          monkeypatch, frac, fn=reference_main)
    for frac in FRACS[1:]:
        assert outs[frac] == outs[1], frac
    for frac in FRACS:
        _assert_within_tol(outs[frac].decode(), refs[frac].decode(),
                           f"frac {frac}", 5e-6)
    pure = rec.runs[0]
    assert pure[5] is None
    for frac, run in zip(FRACS[1:], rec.runs[1:]):
        counts_host, ltot, counts_dev, fix_ids, fix_dv, host_add = run
        np.testing.assert_array_equal(counts_host, pure[0])
        assert ltot == pure[1]
        # the fixed-up resident table is the exact table
        st = engine.stats_program(engine.resident_state(
            counts_dev, ltot, fix_ids, fix_dv,
            [np.full(4, 0.25, np.float32)], "cpu", host_add=host_add),
            6, 0, 0, True)
        np.testing.assert_array_equal(st["counts"].numpy(), counts_host)
        if frac == 0:
            assert host_add is None and fix_ids.size == 0
        else:
            assert host_add is not None and host_add.sum() > 0
            assert torch.as_tensor(counts_dev).sum() > 0


def test_engine_golden_tol_under_split(tmp_path, monkeypatch):
    """A forced split on the golden corpus: byte-identical to the port's
    own default run on the CPU (which does not split: LAST_HYBRID_FRAC
    1.0) and within the engine tolerance of the golden file; on a CPU
    tensor no kernel is launched."""
    data = os.path.join(GOLDEN_DIR, "MafK_100seqs.fasta")
    argv = [data, "-w", "8", "--engine", "tpu", "--device", "cpu"]
    before = th.LAUNCHES
    base = _run(argv, str(tmp_path / "b.meme"), monkeypatch, None)
    assert engine.LAST_HYBRID_FRAC == 1.0
    half = _run(argv, str(tmp_path / "h.meme"), monkeypatch, 0.5)
    assert engine.LAST_HYBRID_FRAC == 0.5
    assert half == base
    assert th.LAUNCHES == before
    with open(os.path.join(GOLDEN_DIR, "mafk100_w8.meme")) as g:
        _assert_within_tol(half.decode(), g.read(), "mafk100_w8", 5e-6)


def test_mesh_never_splits(tmp_path, monkeypatch):
    """--devices counts every sequence on the mesh whatever the forced
    fraction says, and leaves LAST_HYBRID_FRAC unset."""
    data = os.path.join(GOLDEN_DIR, "MafK_100seqs.fasta")
    argv = [data, "-w", "8", "--engine", "tpu", "--device", "cpu"]
    rec = _Phase(monkeypatch)
    base = _run(argv, str(tmp_path / "b.meme"), monkeypatch, 1)
    mesh = _run(argv + ["--devices", "2"], str(tmp_path / "m.meme"),
                monkeypatch, 0)
    assert engine.LAST_HYBRID_FRAC is None
    assert mesh == base
    assert rec.runs[1][5] is None


def test_split_delivers_the_background_counts(tmp_path, monkeypatch):
    """The deferred background model receives device share + host share:
    the counts of the whole corpus, for every fraction."""
    data = os.path.join(GOLDEN_DIR, "MafK_100seqs.fasta")
    from peng_motif_tpu_torch.io.fasta import load_sequence_set
    from peng_motif_tpu_torch.models.background import BackgroundModel

    sset = load_sequence_set(data)
    want = count_kmers(sset.sequences, 2)
    import types

    for frac in FRACS:
        monkeypatch.setenv("PENG_HYBRID_DEVICE_FRAC", str(frac))
        bgm = BackgroundModel(sset.sequences, order=2, interpolate=True,
                              defer=True)
        peng = types.SimpleNamespace(sequence_set=sset, bg_model=bgm)
        engine._count_phase(peng, 8, True, "cpu")
        assert not bgm.deferred
        for g, w in zip(bgm.n, want):
            np.testing.assert_array_equal(g, w)


def test_host_share_bin_above_u16(tmp_path, monkeypatch):
    """A host-share bin past 65,535 rides the int32 ``host_add`` (the
    port has no uint16 form) with identical results, also at frac 0."""
    data = str(tmp_path / "poly.fasta")
    seq = b"ACGT" * 20_000  # 80 kb
    with open(data, "wb") as f:
        for i in range(100):  # 8 Mbases; ACGTACGT bin >> 65535
            f.write(b">s%d\n" % i)
            f.write(seq + b"\n")
    argv = [data, "-w", "8", "--engine", "tpu", "-t", "1000", "--device",
            "cpu"]
    rec = _Phase(monkeypatch)
    outs = [_run(argv, str(tmp_path / f"o{i}.meme"), monkeypatch, frac)
            for i, frac in enumerate((1, 0.5, 0))]
    assert outs[1] == outs[0]
    assert outs[2] == outs[0]
    host_add = rec.runs[1][5]
    assert host_add.dtype == np.int32 and int(host_add.max()) > 65_535
    assert int(np.asarray(rec.runs[2][2]).max()) > 65_535
    ref = _run(argv[:-2], str(tmp_path / "r.meme"), monkeypatch, 0.5,
               fn=reference_main)
    _assert_within_tol(outs[1].decode(), ref.decode(), "poly", 5e-6)
