"""Where the port's count phase counts (ops/hybrid.py and its wiring in
engine._count_phase): on the card or on the host, over the whole corpus,
by one rule.  The end must never change any output — the count table,
ltot and the background model are the same whichever end counts — so
both ends yield byte-identical results on one device.  The rule at its
crossover, the host rows, the host count against the reference
package's host share, error surfacing, the engine's output at either end
on uniform and ragged-with-N corpora (byte-identical to each other;
within the ENGINE_CASES tolerance, 5e-6 + 1e-6 relative, of the
reference engine at the same end), a mesh that ignores the rule, and a
host-table bin above 65,535.  Tests force an end by patching
``hybrid.count_on_host``, the one decision.
"""

import contextlib
import io
import os
import types

import numpy as np
import pytest
import torch

from conftest import GOLDEN_DIR
from test_torch_engine import _assert_within_tol

from peng_motif_tpu.cli import main as reference_main
from peng_motif_tpu.ops import hybrid as jhy
from peng_motif_tpu_torch import engine
from peng_motif_tpu_torch.cli import main
from peng_motif_tpu_torch.io.fasta import load_sequence_set
from peng_motif_tpu_torch.models.background import (BackgroundModel,
                                                    count_kmers)
from peng_motif_tpu_torch.native import count_rows_exact_native
from peng_motif_tpu_torch.ops import histogram as th
from peng_motif_tpu_torch.ops import hybrid as hy
from peng_motif_tpu_torch.utils.logging_utils import PhaseTimer

MAFK100 = os.path.join(GOLDEN_DIR, "MafK_100seqs.fasta")
ENDS = (False, True)     # on the card, on the host


def _force(monkeypatch, on_host):
    """The count phase's end forced to ``on_host`` through the decision
    function; None leaves the rule."""
    if on_host is not None:
        monkeypatch.setattr(hy, "count_on_host", lambda *a: on_host)


def _run(argv, out, monkeypatch, on_host=None, fn=main):
    """One job: (MEME bytes, stdout).  For the reference package the
    end is its own forced fraction (1 = card, 0 = host)."""
    if fn is main:
        _force(monkeypatch, on_host)
    elif on_host is None:
        monkeypatch.delenv("PENG_HYBRID_DEVICE_FRAC", raising=False)
    else:
        monkeypatch.setenv("PENG_HYBRID_DEVICE_FRAC", "0" if on_host else "1")
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        assert fn(argv + ["-o", out]) == 0
    with open(out, "rb") as f:
        return f.read(), stdout.getvalue()


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------

BASES = (1, 10 ** 3, 10 ** 6, 79_613_895, 79_613_896, 10 ** 9)
# the old cost model's answers (host iff B/h < B/d + lat: at W <= 10
# never; at W >= 11 with h 77.6e6, d 463e6, lat 0.854 s up to 79,613,895
# bases), worked out at each size of BASES
ON_HOST = {W: (False,) * 6 for W in range(4, 11)}
ON_HOST.update({W: (True, True, True, True, False, False) for W in (11, 12)})


@pytest.mark.parametrize("W", range(4, 13))
def test_the_rule_picks_an_end(W):
    """On a CUDA device the host counts a W >= 11 table over at most
    79,613,895 bases; everywhere else, and on the CPU always, the
    device counts."""
    got = [hy.count_on_host(torch.device("cuda"), b, W) for b in BASES]
    assert tuple(got) == ON_HOST[W]
    assert [hy.count_on_host("cuda:0", b, W) for b in BASES] == got
    assert not any(hy.count_on_host("cpu", b, W) for b in BASES)
    assert hy.HOST_MAX_BASES == 79_613_895


# ---------------------------------------------------------------------------
# the host count
# ---------------------------------------------------------------------------


def test_host_rows_uniform_and_ragged():
    rng = np.random.default_rng(0)
    seqs = [rng.integers(0, 5, size=12).astype(np.uint8) for _ in range(5)]
    flat = np.concatenate(seqs)
    lens = np.full(5, 12, dtype=np.int64)
    rows = hy._host_rows(seqs, lens, flat)
    assert rows.base is flat or rows.flags["OWNDATA"] is False  # view
    np.testing.assert_array_equal(rows, np.stack(seqs))
    # ragged: padded with zeros, from the flat buffer
    seqs_r = [rng.integers(1, 5, size=n).astype(np.uint8)
              for n in (7, 3, 9, 4)]
    lens_r = np.array([7, 3, 9, 4], np.int64)
    flat_r = np.concatenate(seqs_r)
    rows_r = hy._host_rows(seqs_r, lens_r, flat_r)
    want = np.zeros((4, 9), np.uint8)
    for i, s in enumerate(seqs_r):
        want[i, : len(s)] = s
    np.testing.assert_array_equal(rows_r, want)
    np.testing.assert_array_equal(
        rows_r, jhy._host_rows(seqs_r, lens_r, flat_r, 0))
    # no flat buffer, or a stale one: built from the sequence list
    np.testing.assert_array_equal(hy._host_rows(seqs_r, lens_r, None), want)
    np.testing.assert_array_equal(
        hy._host_rows(seqs_r, lens_r, flat_r[:-1]), want)
    assert hy._host_rows([], np.zeros(0, np.int64), None).shape == (0, 1)


def test_host_share_counts_match_full_scan():
    """The host count of a ragged corpus is the reference package's host
    share over the same corpus (table, ltot, background counts), on the
    calling thread under the span ``host``, with the native count's
    ``scan`` and ``mirror`` inside."""
    rng = np.random.default_rng(3)
    seqs = [rng.integers(0, 5, size=rng.integers(20, 90)).astype(np.uint8)
            for _ in range(40)]
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    flat = np.concatenate(seqs)
    with PhaseTimer().activate() as recorder:
        tab, ltot, bg = hy.host_count(seqs, lens, flat, 6, True, bg_order=2)
    (host,) = [s for s in recorder.spans if s.path == "host"]
    for name in ("scan", "mirror"):
        (part,) = [s for s in recorder.spans if s.path == f"host.{name}"]
        assert part.parent == host.id and part.thread == host.thread
        assert host.start_ns <= part.start_ns <= part.end_ns <= host.end_ns
    full_tab, full_ltot = count_rows_exact_native(
        hy._host_rows(seqs, lens, flat), 6, True)
    np.testing.assert_array_equal(tab, full_tab)
    assert ltot == full_ltot
    for g, w in zip(bg, count_kmers(seqs, 2)):
        np.testing.assert_array_equal(g, w)
    r_tab, r_ltot, r_bg = jhy.start_host_share(
        seqs, lens, flat, 0, 6, True, bg_order=2).join()
    np.testing.assert_array_equal(tab, r_tab)
    assert ltot == r_ltot
    for k in range(3):
        np.testing.assert_array_equal(bg[k], r_bg[k])
    # no background scan unless asked for
    assert hy.host_count(seqs, lens, None, 6, True)[2] is None


def test_host_share_error_surfaces():
    with pytest.raises(Exception):   # invalid W: the scan fails loudly
        hy.host_count([np.array([1, 2, 3], np.uint8)],
                      np.array([3], np.int64), None, -1, True)


def test_failing_host_share_fails_the_run(tmp_path, monkeypatch):
    """A host count that raises fails the run: no fallback to a device
    count, none to the exact engine."""
    class Boom(RuntimeError):
        pass

    def broken(*a, **k):
        raise Boom("host count broke")

    monkeypatch.setattr(hy, "count_rows_exact_native", broken)
    _force(monkeypatch, True)
    out = tmp_path / "o.meme"
    with pytest.raises(Boom):
        main([MAFK100, "-w", "8", "--device", "cpu", "--engine", "tpu",
              "-o", str(out)])
    assert not out.exists()


# ---------------------------------------------------------------------------
# end to end: both ends yield identical output
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


def _resident(run, W):
    """The resident table of a count phase's output at width ``W``,
    completed as the stats program completes it."""
    counts_host, ltot, counts_dev, fix_ids, fix_dv = run
    st = engine.stats_program(engine.resident_state(
        counts_dev, ltot, fix_ids, fix_dv, [np.full(4, 0.25, np.float32)],
        "cpu"), W, 0, 0, True)
    return st["counts"].numpy()


@pytest.mark.parametrize("ragged_n", [False, True],
                         ids=["uniform", "ragged_n"])
def test_engine_output_invariant_under_split(tmp_path, monkeypatch,
                                             ragged_n):
    """Card and host byte-identical, MEME and stdout, on uniform and
    ragged+N corpora (the same device programs on both runs, so the
    invariance is exact), the count phase's tables equal, and each run
    within the engine tolerance of the reference engine at the same
    end."""
    rng = np.random.default_rng(11 if ragged_n else 5)
    data = str(tmp_path / "c.fasta")
    if ragged_n:
        _write_corpus(data, rng, 120, 60, 140, with_n=True)
    else:
        _write_corpus(data, rng, 150, 100, 100)
    argv = [data, "-w", "6", "--engine", "tpu"]
    rec = _Phase(monkeypatch)
    outs, refs = {}, {}
    for on_host in ENDS:
        outs[on_host] = _run(argv + ["--device", "cpu"],
                             str(tmp_path / f"o{on_host}.meme"), monkeypatch,
                             on_host)
        assert engine.LAST_HYBRID_FRAC == (0.0 if on_host else 1.0)
        assert engine.LAST_ENGINE_USED == "cpu"
        refs[on_host] = _run(argv, str(tmp_path / f"r{on_host}.meme"),
                             monkeypatch, on_host, fn=reference_main)
    assert outs[True] == outs[False]
    for on_host in ENDS:
        _assert_within_tol(outs[on_host][0].decode(),
                           refs[on_host][0].decode(), f"host {on_host}", 5e-6)
    card, host = rec.runs
    np.testing.assert_array_equal(host[0], card[0])
    assert host[1] == card[1]
    # the completed resident table is the exact table at either end
    for run in (card, host):
        np.testing.assert_array_equal(_resident(run, 6), card[0])
    # the host's table is the resident table, with an empty fix-up
    assert host[2] is host[0] and host[3].size == host[4].size == 0
    assert torch.as_tensor(card[2]).sum() > 0


def test_engine_golden_tol_under_split(tmp_path, monkeypatch):
    """The golden corpus counted on the host: byte-identical to the
    port's own default run on the CPU (the device count: LAST_HYBRID_FRAC
    1.0) and within the engine tolerance of the golden file; on a CPU
    tensor no kernel is launched."""
    argv = [MAFK100, "-w", "8", "--engine", "tpu", "--device", "cpu"]
    before = th.LAUNCHES
    base = _run(argv, str(tmp_path / "b.meme"), monkeypatch)
    assert engine.LAST_HYBRID_FRAC == 1.0
    host = _run(argv, str(tmp_path / "h.meme"), monkeypatch, True)
    assert engine.LAST_HYBRID_FRAC == 0.0
    assert host == base
    assert th.LAUNCHES == before
    with open(os.path.join(GOLDEN_DIR, "mafk100_w8.meme")) as g:
        _assert_within_tol(host[0].decode(), g.read(), "mafk100_w8", 5e-6)


def test_mesh_never_splits(tmp_path, monkeypatch):
    """--devices counts every sequence on the mesh whatever the rule
    says (it is not asked), and leaves LAST_HYBRID_FRAC unset."""
    argv = [MAFK100, "-w", "8", "--engine", "tpu", "--device", "cpu"]
    rec = _Phase(monkeypatch)
    base = _run(argv, str(tmp_path / "b.meme"), monkeypatch)
    asked = []
    monkeypatch.setattr(hy, "count_on_host",
                        lambda *a: asked.append(a) or True)
    mesh = _run(argv + ["--devices", "2"], str(tmp_path / "m.meme"),
                monkeypatch)
    assert engine.LAST_HYBRID_FRAC is None and not asked
    assert mesh == base
    # the table the mesh counted is resident on its first device
    assert isinstance(rec.runs[1][2], torch.Tensor)


def test_split_delivers_the_background_counts(monkeypatch):
    """The deferred background model receives the counts of the whole
    corpus at either end: the fused device histogram with its host
    corrections, or the host count's own scan."""
    sset = load_sequence_set(MAFK100)
    want = count_kmers(sset.sequences, 2)
    for on_host in ENDS:
        _force(monkeypatch, on_host)
        bgm = BackgroundModel(sset.sequences, order=2, interpolate=True,
                              defer=True)
        peng = types.SimpleNamespace(sequence_set=sset, bg_model=bgm)
        engine._count_phase(peng, 8, True, "cpu")
        assert engine.LAST_HYBRID_FRAC == (0.0 if on_host else 1.0)
        assert not bgm.deferred
        for g, w in zip(bgm.n, want):
            np.testing.assert_array_equal(g, w)


def test_host_share_bin_above_u16(tmp_path, monkeypatch):
    """A host-table bin past 65,535 reaches the resident int32 table (the
    port has no uint16 form) with output identical to the device
    count's."""
    data = str(tmp_path / "poly.fasta")
    seq = b"ACGT" * 20_000  # 80 kb
    with open(data, "wb") as f:
        for i in range(100):  # 8 Mbases; ACGTACGT bin >> 65535
            f.write(b">s%d\n" % i)
            f.write(seq + b"\n")
    argv = [data, "-w", "8", "--engine", "tpu", "-t", "1000", "--device",
            "cpu"]
    rec = _Phase(monkeypatch)
    outs = [_run(argv, str(tmp_path / f"o{on_host}.meme"), monkeypatch,
                 on_host) for on_host in ENDS]
    assert outs[1] == outs[0]
    host = rec.runs[1]
    assert host[2].dtype == np.int32 and int(host[2].max()) > 65_535
    resident = _resident(host, 8)
    assert resident.dtype == np.int32 and int(resident.max()) > 65_535
    np.testing.assert_array_equal(resident, rec.runs[0][0])
    ref = _run(argv[:-2], str(tmp_path / "r.meme"), monkeypatch, True,
               fn=reference_main)
    _assert_within_tol(outs[1][0].decode(), ref[0].decode(), "poly", 5e-6)
