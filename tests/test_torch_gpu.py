"""Card-only tests of the port: the CUDA histogram kernel against its
plain PyTorch version, the stream count, the exact engine's batch count
and the post-count programs (flat tables, stats, walks, adv-PWM, EM) on
the card against the same programs on the CPU, and the CLI through the
kernel (device engine, and the exact engine with its count forced onto
the card).  Every test skips without a CUDA device.  The multi-card
tests at the end (the kernel on every card, the sharded counts, the
count phase and the CLI over distinct cards, multi-process jobs over
NCCL with one or two cards a process, dryrun_multichip) ask the
``cards(n)`` fixture for their cards and skip on a machine with fewer.

This file imports neither jax nor the reference package, so that it runs
on a machine without them:

    python -m pytest --noconftest tests/test_torch_gpu.py -q

Tolerances: counts, integer contractions, the background tables,
adv-PWMs and the walks' integer trace fields bit-identical; walk
aggregates within 1e-6 relative and scores within 2e-6 relative + 2e-5
absolute; EM PWMs within 5e-6 with identical iteration counts; the
seeds' background table fetched from the card bit-identical to the host
fold; MEME
output within the ENGINE_CASES tolerance of the golden files (5e-6
absolute + 1e-6 relative; 2e-5 for the merge-heavy mafk_w8_rich); the
device engine against the exact engine on a 20-Mbase corpus with every
non-float token equal and floats within 1e-4 + 1e-5 relative; the
output byte-identical whichever end counts (card or host); entry()'s
z-scores within 1e-6 of the CPU's.  The recorder's counters
(utils/logging_utils) on the benchmark cells' jobs: ``syncs`` equal to
the warnings of torch's sync debug mode, ``h2d.copies`` and
``h2d.bytes`` to the host-to-device copies of the device trace, exactly.

The count is pinned to the card (``hybrid.count_on_host`` patched to
answer False) for every test that does not name an end of its own: these
tests hold the kernel on the whole input.
"""

import collections
import contextlib
import io
import json
import os
import warnings

import numpy as np
import pytest
import torch

from peng_motif_tpu_torch import engine, graft_entry
from peng_motif_tpu_torch.bench_histogram import EDGE_NAMES, edge_tensors
from peng_motif_tpu_torch.cli import main
from peng_motif_tpu_torch.ops import climb as tcl
from peng_motif_tpu_torch.ops import counting as tcnt
from peng_motif_tpu_torch.ops import em as tem
from peng_motif_tpu_torch.ops import flat_tables as tft
from peng_motif_tpu_torch.ops import histogram as th
from peng_motif_tpu_torch.ops import hybrid as thy
from peng_motif_tpu_torch.ops import stream_count as tsc
from peng_motif_tpu_torch.models import background as tbg
from peng_motif_tpu_torch.parallel import multihost as tmh
from peng_motif_tpu_torch.parallel import sharded as tsh
from peng_motif_tpu_torch.parallel.mesh import make_data_mesh
from peng_motif_tpu_torch.utils.logging_utils import PhaseTimer

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "golden")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.gpu

# the rule that picks where the count phase counts, as the cells run it
RULE = thy.count_on_host


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the histogram kernel runs only "
                    "on the card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def pure_device_count(monkeypatch):
    monkeypatch.setattr(thy, "count_on_host", lambda *a: False)


def _inputs(n, n_bins, seed, frac=0.8):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_bins, size=n).astype(np.int32),
            rng.random(n) < frac)


@pytest.mark.parametrize("n_bins", [384, 4 ** 6, 4 ** 7, 58_112, 4 ** 8,
                                    4 ** 9, 4 ** 10, 4 ** 12])
def test_kernel_matches_plain(n_bins, cuda):
    """Every tier of the dispatcher at full width: one slice of shared
    memory (to 58,112 bins: 232,448 B), slices (4**8, 4**9), L2 (4**10)
    and L2 in bin-range passes (4**12): one launch per pass."""
    ids, inc = _inputs(2_000_000, n_bins, seed=7)
    ids_d = torch.from_numpy(ids).to(cuda)
    inc_d = torch.from_numpy(inc).to(cuda)
    plan = th.plan(n_bins, ids.size)
    before, tier_before = th.LAUNCHES, th.TIER_LAUNCHES[plan.tier]
    got = th.histogram(ids_d, inc_d, n_bins)
    torch.cuda.synchronize()
    passes = len(plan.ranges)
    assert passes == (3 if n_bins == 4 ** 12 else 1)
    assert th.LAUNCHES == before + passes
    assert th.TIER_LAUNCHES[plan.tier] == tier_before + passes
    assert torch.equal(got, th.histogram_plain(ids_d, inc_d, n_bins))
    assert torch.equal(got.cpu(), th.histogram(torch.from_numpy(ids),
                                               torch.from_numpy(inc), n_bins))


@pytest.mark.parametrize("edge", ["empty", "all_masked", "one_hot_bin",
                                  "last_bin"])
@pytest.mark.parametrize("inc_dtype", [torch.bool, torch.uint8, torch.int32])
def test_kernel_edge_inputs(edge, inc_dtype, cuda):
    for n_bins in (384, 4 ** 9):
        ids, inc = _inputs(3000, n_bins, seed=1)
        if edge == "empty":
            ids, inc = ids[:0], inc[:0]
        elif edge == "all_masked":
            inc[:] = False
        elif edge == "one_hot_bin":
            ids[:] = n_bins // 3
        else:
            ids[::5] = n_bins - 1
        ids_d = torch.from_numpy(ids).to(cuda)
        inc_d = torch.from_numpy(inc).to(cuda, inc_dtype)
        got = th.histogram(ids_d, inc_d, n_bins)
        torch.cuda.synchronize()
        assert torch.equal(got, th.histogram_plain(ids_d, inc_d, n_bins))


@pytest.mark.parametrize("n_bins", [384, 4 ** 8, 4 ** 10, 4 ** 12])
@pytest.mark.parametrize("edge", EDGE_NAMES)
def test_kernel_shared_edge_inputs(edge, n_bins, cuda):
    """The edge inputs of bench_histogram.edge_input (unaligned slices,
    ragged lengths, junk in masked ids, flags of 2 and 255, counted ids
    outside the table, 2**24 inputs in one bin) through each tier."""
    ids, inc = edge_tensors(edge, n_bins, cuda)
    got = th.histogram(ids, inc, n_bins)
    torch.cuda.synchronize()
    assert torch.equal(got, th.histogram_plain(ids, inc, n_bins))
    assert torch.equal(got.cpu(), th.histogram(ids.cpu(), inc.cpu(), n_bins))


@pytest.mark.parametrize("n_bins", [384, 4 ** 8, 4 ** 10, 4 ** 12])
def test_kernel_out_accumulates(n_bins, cuda):
    ids, inc = _inputs(1_500_001, n_bins, seed=9)
    ids_d = torch.from_numpy(ids).to(cuda)[1:]
    inc_d = torch.from_numpy(inc).to(cuda)[1:]
    run = torch.arange(n_bins, dtype=torch.int32, device=cuda)
    want = run + th.histogram_plain(ids_d, inc_d, n_bins)
    assert th.histogram(ids_d, inc_d, n_bins, out=run) is run
    torch.cuda.synchronize()
    assert torch.equal(run, want)
    with pytest.raises(ValueError):
        th.histogram(ids_d, inc_d, n_bins, out=run.cpu())


def test_kernel_rejects_mixed_devices(cuda):
    with pytest.raises(ValueError):
        th.histogram(torch.zeros(4, dtype=torch.int32, device=cuda),
                     torch.ones(4, dtype=torch.bool), 8)


@pytest.mark.parametrize("wire2", [False, True], ids=["mask", "wire2"])
def test_stream_count_on_card_matches_cpu(wire2, cuda):
    rng = np.random.default_rng(5)
    W = 8
    if wire2:
        seqs = [rng.integers(1, 5, size=400).astype(np.uint8)
                for _ in range(300)]
    else:
        seqs = [rng.integers(0, 5, size=int(n)).astype(np.uint8)
                for n in rng.integers(3, 3000, size=200)]
    flat = np.concatenate(seqs)
    outs = {}
    for dev in ("cpu", cuda):
        _, lay, out = tsh.stream_count_sharded(
            seqs, W, True, (torch.device(dev),), flat_codes=flat, bg_order=2)
        assert tsc.wire2_eligible(lay, int((flat == 0).sum())) == wire2
        outs[str(dev)] = [t.cpu() for t in out]
    for a, b in zip(outs["cpu"], outs[str(cuda)]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("wire2", [False, True], ids=["mask", "wire2"])
def test_stream_count_sharded_on_card_matches_cpu(wire2, cuda):
    """Four shards on the one card (every shard launches the kernel for
    both tables) against four shards on the CPU: identical integers."""
    rng = np.random.default_rng(6)
    W = 8
    if wire2:
        seqs = [rng.integers(1, 5, size=400).astype(np.uint8)
                for _ in range(300)]
    else:
        seqs = [rng.integers(0, 5, size=int(n)).astype(np.uint8)
                for n in rng.integers(3, 3000, size=200)]
    flat = np.concatenate(seqs)
    before = dict(th.TIER_LAUNCHES)
    outs = {}
    for dev in ("cpu", cuda):
        _, lay, out = tsh.stream_count_sharded(
            seqs, W, True, (torch.device(dev),) * 4, flat_codes=flat,
            bg_order=2)
        assert tsc.wire2_eligible(lay, int((flat == 0).sum())) == wire2
        outs[str(dev)] = [t.cpu() for t in out]
    # 4 shards x (the 4**8 table + the background table), shared tier
    assert th.TIER_LAUNCHES["shared"] == before["shared"] + 8
    for a, b in zip(outs["cpu"], outs[str(cuda)]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("both", [True, False], ids=["both", "plus"])
def test_batch_and_bg_counts_sharded_on_card_match_cpu(both, cuda):
    rng = np.random.default_rng(12)
    codes = rng.integers(1, 5, size=(301, 640)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 0
    codes[4, :128] = np.tile(np.array([1, 3], dtype=np.uint8), 64)
    host = tcnt.CountJob(codes, 8, both, "cpu").finish()
    before = th.LAUNCHES
    got = tsh.count_patterns_sharded(codes, 8, both, (cuda,) * 4)
    assert th.LAUNCHES == before + 4
    np.testing.assert_array_equal(got[0], host[0])
    assert got[1] == host[1]
    full = tsh.count_device_full_sharded(codes, 8, both, (cuda,) * 4)
    cpu = tsh.count_device_full_sharded(codes, 8, both,
                                        make_data_mesh(4, "cpu"))
    for a, b in zip(full[:4], cpu[:4]):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)
    lengths = rng.integers(600, 641, size=codes.shape[0]).astype(np.int32)
    seqs = [codes[i, : lengths[i]] for i in range(codes.shape[0])]
    before = th.LAUNCHES
    bg = tsh.count_bg_kmers_sharded(codes, 2, (cuda,) * 4, lengths=lengths)
    assert th.LAUNCHES == before + 4 * 3
    for g, w in zip(bg, tbg.count_kmers(seqs, 2)):
        np.testing.assert_array_equal(g, w)


def test_mesh_beyond_the_machine_is_an_error(cuda, tmp_path, capsys):
    """More cards than the machine has: make_data_mesh raises and the
    CLI exits with that error; neither runs on the cards there are."""
    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match=f"requested {n} devices, only "
                                         f"{n - 1} available"):
        make_data_mesh(n, cuda)
    assert make_data_mesh(None, cuda) == tuple(
        torch.device("cuda", i) for i in range(n - 1))
    out = tmp_path / "o.meme"
    rc = main([os.path.join(GOLDEN_DIR, "MafK_100seqs.fasta"), "-w", "8",
               "--devices", str(n), "-o", str(out)])
    assert rc != 0 and not out.exists()
    assert f"requested {n} devices" in capsys.readouterr().err


@pytest.mark.parametrize("engine_flag", ["tpu", "exact"])
def test_cli_devices_one_on_card(engine_flag, cuda, tmp_path):
    """--devices 1 --device cuda: the mesh paths of both engines launch
    the kernel and reproduce the run without --devices byte for byte."""
    outs = {}
    for label, extra in (("mesh", ["--devices", "1"]), ("single", [])):
        th.LAUNCHES = 0
        meme = tmp_path / f"{label}.meme"
        assert main([os.path.join(GOLDEN_DIR, "MafK.fasta"), "-w", "8",
                     "--device", "cuda", "--engine", engine_flag, "-o",
                     str(meme)] + extra) == 0
        if label == "mesh":
            # exact: one batch count + three background tables
            assert th.LAUNCHES == (2 if engine_flag == "tpu" else 4)
        outs[label] = meme.read_bytes()
    assert outs["mesh"] == outs["single"]
    if engine_flag == "exact":
        with open(os.path.join(GOLDEN_DIR, "mafk_w8.meme"), "rb") as g:
            assert outs["mesh"] == g.read()


def test_world_of_one_on_card_takes_nccl(cuda):
    """One process that owns its card: the collectives go over NCCL, on
    device tensors, and the count equals the host scan."""
    import socket

    rng = np.random.default_rng(4)
    seqs = [rng.integers(0, 5, size=int(n)).astype(np.uint8)
            for n in rng.integers(3, 3000, size=200)]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = tmh.init_multihost(f"localhost:{port}", 1, 0, timeout_s=120,
                             device=cuda)
    try:
        assert tmh.LAST_BACKEND == ctx.backend == "nccl"
        assert ctx.device.type == "cuda" and ctx.group is not None
        before = th.LAUNCHES
        counts, ltot = tmh.multihost_stream_counts(ctx, seqs, 8, True)
        assert th.LAUNCHES > before
        bg = tmh.multihost_bg_counts(ctx, seqs, 2)
    finally:
        tmh.shutdown_multihost()
    codes = np.zeros((len(seqs), max(len(s) for s in seqs)), dtype=np.uint8)
    for i, s in enumerate(seqs):
        codes[i, : len(s)] = s
    want, want_ltot = tcnt.CountJob(codes, 8, True, "cpu").finish()
    np.testing.assert_array_equal(counts, want)
    assert ltot == want_ltot
    for g, w in zip(bg, tbg.count_kmers(seqs, 2)):
        np.testing.assert_array_equal(g, w)


def _within_tol(got, want, tol=5e-6, rel=1e-6):
    a_lines, b_lines = got.splitlines(), want.splitlines()
    assert len(a_lines) == len(b_lines)
    for a, b in zip(a_lines, b_lines):
        ta, tb = a.split(), b.split()
        assert len(ta) == len(tb), (a, b)
        for x, y in zip(ta, tb):
            if x != y:
                assert abs(float(x) - float(y)) <= tol + rel * abs(float(y)), \
                    (a, b)


@pytest.mark.parametrize("stem,args", [
    ("mafk100_w8", ["MafK_100seqs.fasta", "-w", "8"]),
    ("mafk_w8", ["MafK.fasta", "-w", "8"]),
    ("mafk_w10", ["MafK.fasta", "-w", "10"]),
    ("synth_w8", ["synthetic_n.fasta", "-w", "8"]),
    ("synth_w8_plus", ["synthetic_n.fasta", "-w", "8", "--strand", "PLUS"]),
    # the rest of the reference's hardware parity list
    ("mafk100_w8_plus", ["MafK_100seqs.fasta", "-w", "8", "--strand",
                         "PLUS"]),
    ("mafk100_w8_logpval", ["MafK_100seqs.fasta", "-w", "8",
                            "--optimization_score", "LOGPVAL"]),
    ("mafk100_w8_enrich", ["MafK_100seqs.fasta", "-w", "8",
                           "--optimization_score", "ENRICHMENT"]),
    ("mafk100_w12", ["MafK_100seqs.fasta", "-w", "12"]),
    ("mafk_w8_rich", ["MafK.fasta", "-w", "8", "-t", "5",
                      "--minimum-processed-patterns", "25"])])
def test_cli_golden_through_kernel(stem, args, cuda, tmp_path):
    th.LAUNCHES = 0
    meme = tmp_path / "o.meme"
    assert main([os.path.join(GOLDEN_DIR, args[0])] + args[1:]
                + ["--device", "cuda", "--engine", "tpu", "-o",
                   str(meme)]) == 0
    assert engine.LAST_ENGINE_USED == "gpu"
    assert engine.LAST_CLIMB_ENGINE == engine.LAST_PWM_ENGINE == "device"
    assert th.LAUNCHES > 0
    with open(os.path.join(GOLDEN_DIR, f"{stem}.meme")) as g:
        _within_tol(meme.read_text(), g.read(),
                    tol=2e-5 if stem == "mafk_w8_rich" else 5e-6)


def test_large_corpus_wide_path(cuda, tmp_path, capsys):
    """A 20-Mbase corpus (ltot >= 2**24: the f64 "wide" chain) at -w 8:
    the device engine must not fall back, and against the exact engine
    every non-float token of the MEME file and of stdout (seed table,
    climb rows, selections, EM and merge lines) must be equal and every
    float within 1e-4 + 1e-5 relative (EM amplifies the f32 summation
    order at ~5e7 counts)."""
    rng = np.random.default_rng(13)
    let = np.frombuffer(b"ACGT", dtype=np.uint8)
    n_seq, L = 10_000, 2_000
    rows = let[rng.integers(0, 4, size=(n_seq, L))]
    mot = np.frombuffer(b"TGACTCAC", dtype=np.uint8)
    pos = rng.integers(0, L - 8, size=n_seq)
    for i in np.flatnonzero(rng.random(n_seq) < 0.25):
        rows[i, pos[i]: pos[i] + 8] = mot
    fa = tmp_path / "large20.fasta"
    with open(fa, "wb") as f:
        for i in range(n_seq):
            f.write(b">s%d\n" % i)
            f.write(rows[i].tobytes())
            f.write(b"\n")
    outs = {}
    for eng in ("tpu", "exact"):
        meme = tmp_path / f"{eng}.meme"
        capsys.readouterr()
        before = th.LAUNCHES
        assert main([str(fa), "-w", "8", "--device", "cuda", "--engine", eng,
                     "-o", str(meme)]) == 0
        assert engine.LAST_ENGINE_USED == ("gpu" if eng == "tpu" else "exact")
        if eng == "tpu":
            assert th.LAUNCHES > before
        outs[eng] = (meme.read_text(), capsys.readouterr().out)
    for got, want in zip(outs["tpu"], outs["exact"]):
        _within_tol(got, want, tol=1e-4, rel=1e-5)


@pytest.mark.parametrize("fasta,w", [("MafK.fasta", "8"),
                                     ("synthetic_n.fasta", "8"),
                                     ("MafK_100seqs.fasta", "12")])
def test_co_count_never_changes_the_output(fasta, w, cuda, tmp_path,
                                           monkeypatch, capsys):
    """The count forced onto the card and onto the host, and left to the
    rule: MEME bytes and stdout identical, the kernel launched unless the
    host counted, LAST_HYBRID_FRAC as forced or as the rule answers."""
    from peng_motif_tpu_torch.io.fasta import load_sequence_set

    path = os.path.join(GOLDEN_DIR, fasta)
    outs = {}
    for on_host in (False, True, None):
        rule = RULE if on_host is None else (lambda *a, h=on_host: h)
        monkeypatch.setattr(thy, "count_on_host", rule)
        meme = tmp_path / f"{on_host}.meme"
        capsys.readouterr()
        before = th.LAUNCHES
        assert main([path, "-w", w, "--device", "cuda", "--engine", "tpu",
                     "-o", str(meme)]) == 0
        assert engine.LAST_ENGINE_USED == "gpu"
        if on_host is None:
            on_host = RULE(cuda, load_sequence_set(path).total_bases, int(w))
        assert engine.LAST_HYBRID_FRAC == (0.0 if on_host else 1.0)
        assert (th.LAUNCHES == before) == on_host
        outs[on_host] = (meme.read_bytes(), capsys.readouterr().out)
    for on_host, out in outs.items():
        assert out == outs[False], on_host


def test_host_share_fills_the_resident_table(cuda, monkeypatch):
    """engine._count_phase at either end: the resident table plus the
    fix-up pairs is the exact host table, as stats_program computes it on
    the card, and table, ltot and background counts are the same at both
    ends."""
    from types import SimpleNamespace

    from peng_motif_tpu_torch.io.fasta import load_sequence_set

    sset = load_sequence_set(os.path.join(GOLDEN_DIR, "synthetic_n.fasta"))
    tables = {}
    for on_host in (False, True):
        monkeypatch.setattr(thy, "count_on_host", lambda *a: on_host)
        peng = SimpleNamespace(
            sequence_set=sset,
            bg_model=tbg.BackgroundModel(sset.sequences, order=2,
                                         interpolate=True, defer=True))
        host, ltot, dev, fix_ids, fix_dv = engine._count_phase(
            peng, 8, True, cuda)
        # the host's table is the resident table, with an empty fix-up
        assert (dev is host and fix_ids.size == 0) == on_host
        st = engine.stats_program(
            engine.resident_state(dev, ltot, fix_ids, fix_dv,
                                  peng.bg_model.v, cuda), 8, 2, 2, True)
        assert st["counts"].device.type == "cuda"
        np.testing.assert_array_equal(st["counts"].cpu().numpy(), host)
        tables[on_host] = (host, ltot, [n.copy() for n in peng.bg_model.n])
    for host, ltot, bg in tables.values():
        np.testing.assert_array_equal(host, tables[False][0])
        assert ltot == tables[False][1]
        for a, b in zip(bg, tables[False][2]):
            np.testing.assert_array_equal(a, b)


def test_planner_defaults_and_overrides(cuda):
    """The rule picks an end per width and size: the card at W <= 10
    whatever the corpus, the host for a W >= 11 table over at most
    79,613,895 bases (MafK at -w 12, the w12 cell's corpus), the card
    above; off CUDA always the device."""
    for W in (8, 10):
        assert not RULE(cuda, 1_025_000, W)
        assert not RULE(cuda, 51_200_000, W)
    assert RULE(cuda, 20_000, 12) and RULE(cuda, 1_025_000, 12)
    assert RULE(cuda, 51_200_000, 12) and RULE(cuda, 79_613_895, 12)
    assert not RULE(cuda, 79_613_896, 12)
    assert not RULE("cpu", 1_025_000, 12)


def test_entry_runs_on_the_card(cuda):
    """graft_entry.entry(): no device named means the card; one histogram
    launch; z-scores within 1e-6 (relative and absolute) of the CPU's."""
    fn, args = graft_entry.entry()
    before = th.LAUNCHES
    z = fn(*args)
    torch.cuda.synchronize()
    assert th.LAUNCHES == before + 1
    assert z.device.type == "cuda" and z.shape == (4 ** 6,)
    assert z.dtype == torch.float32 and bool(torch.isfinite(z).all())
    torch.testing.assert_close(z.cpu(), fn(*args, device="cpu"), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("W", [4, 6, 8])
def test_rank_w_ops_on_card_match_cpu(W, cuda):
    """bg_prob_table, aggregate_double_strand, rc_permute and the int32
    contraction bit-identical; float contractions within 1e-5 relative;
    the rank-W EM's iteration counts identical, PWMs within 5e-6."""
    from peng_motif_tpu_torch.ops import bgprobs, encoding, iupac_sum

    rng = np.random.default_rng(W)
    counts = rng.integers(0, 70_000, size=4 ** W).astype(np.int32)
    v = [rng.uniform(0.05, 1, size=4 ** (k + 1)).astype(np.float32)
         for k in range(3)]
    masks = rng.integers(0, 2, size=(16, W, 4)).astype(np.int32)
    pwms = rng.dirichlet(np.ones(4), size=(5, W)).astype(np.float32)
    outs = {}
    for d in (cuda, torch.device("cpu")):
        agg = bgprobs.aggregate_double_strand(bgprobs.bg_prob_table(
            [torch.from_numpy(x).to(d) for x in v], W, 2))
        canon = encoding.canonical_mask(W, d)
        counts_t = encoding.to_tensor(torch.from_numpy(counts).to(d), W)
        sym = counts_t + encoding.rc_permute(counts_t)
        c, f = iupac_sum.aggregate_batch(
            counts_t * canon, (agg * canon)[None],
            torch.from_numpy(masks).to(d), True)
        pwm, it = tem.em_optimize(torch.from_numpy(pwms).to(d),
                                  sym.to(torch.float32), agg, 1e4, 0.08, 10,
                                  W)
        outs[d.type] = [x.cpu() for x in (agg, sym, c, f, pwm, it)]
    a, b = outs["cuda"], outs["cpu"]
    for i in (0, 1, 2, 5):
        assert torch.equal(a[i], b[i]), i
    torch.testing.assert_close(a[3], b[3], rtol=1e-5, atol=0)
    torch.testing.assert_close(a[4], b[4], rtol=0, atol=5e-6)


@pytest.mark.parametrize("both", [True, False], ids=["both", "plus"])
def test_batch_count_on_card_matches_cpu(both, cuda, monkeypatch):
    """count_patterns and the CountJob device path at W 10: the card's
    table and ltot equal the CPU's (plain histogram) and the host scan's,
    with tandem repeats taking the row fix-up."""
    rng = np.random.default_rng(9)
    codes = rng.integers(1, 5, size=(300, 640)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 0   # Ns
    codes[4, :128] = np.tile(np.array([1, 3], dtype=np.uint8), 64)
    host = tcnt.CountJob(codes, 10, both, "cpu").finish()
    monkeypatch.setenv("PENG_COUNT_HOST_MAX_BASES", "0")
    before = th.LAUNCHES
    dev = tcnt.CountJob(codes, 10, both, cuda).finish()
    assert th.LAUNCHES == before + 1
    cpu = tcnt.CountJob(codes, 10, both, "cpu").finish()
    for counts, ltot in (dev, cpu):
        assert ltot == host[1]
        np.testing.assert_array_equal(counts, host[0])
    got, ltot = tcnt.count_patterns(torch.from_numpy(codes).to(cuda), 10,
                                    both)
    assert got.device.type == "cuda" and ltot == host[1]
    np.testing.assert_array_equal(got.cpu().numpy(), host[0])


@pytest.mark.parametrize("stem,args", [
    ("mafk100_w8", ["MafK_100seqs.fasta", "-w", "8"]),
    ("mafk_w8", ["MafK.fasta", "-w", "8"]),
    ("synth_w8", ["synthetic_n.fasta", "-w", "8"]),
    ("synth_w8_plus", ["synthetic_n.fasta", "-w", "8", "--strand", "PLUS"])])
def test_exact_engine_device_count_on_card(stem, args, cuda, tmp_path,
                                           monkeypatch):
    """--engine exact with the count forced onto the card
    (PENG_COUNT_HOST_MAX_BASES=0): the kernel launches and the output is
    byte-identical to the host-count run and to the golden file."""
    outs = {}
    for path in ("host", "device"):
        if path == "device":
            monkeypatch.setenv("PENG_COUNT_HOST_MAX_BASES", "0")
        th.LAUNCHES = 0
        meme = tmp_path / f"{path}.meme"
        assert main([os.path.join(GOLDEN_DIR, args[0])] + args[1:]
                    + ["--device", "cuda", "--engine", "exact", "-o",
                       str(meme)]) == 0
        assert engine.LAST_ENGINE_USED == "exact"
        outs[path] = (meme.read_bytes(), th.LAUNCHES)
    assert outs["host"][1] == 0 and outs["device"][1] > 0
    assert outs["device"][0] == outs["host"][0]
    with open(os.path.join(GOLDEN_DIR, f"{stem}.meme"), "rb") as g:
        assert outs["host"][0] == g.read()


# -- post-count programs, card against CPU ----------------------------------


def _rc(ids, W):
    rc = np.zeros_like(ids)
    for p in range(W):
        rc |= (3 - ((ids >> (2 * p)) & 3)) << (2 * (W - 1 - p))
    return rc


def _walk_inputs(W, seed, n_seeds=10, ltot=300_000):
    """Mirrored counts over a random background with a planted motif;
    seeds the top z-scores (the inputs of tests/test_torch_climb.py)."""
    rng = np.random.default_rng(seed)
    n = 4 ** W
    ids = np.arange(n)
    bgp = rng.uniform(0.5, 1.5, size=n)
    bgp = (bgp / bgp.sum()).astype(np.float32)
    counts = rng.poisson(bgp * np.float32(ltot)).astype(np.int64)
    motif = rng.integers(0, 4, size=W)
    mism = np.zeros(n, dtype=np.int64)
    for p in range(W):
        mism += ((ids >> (2 * p)) & 3) != motif[p]
    counts += np.where(mism == 0, 400, np.where(mism == 1, 60, 0))
    counts = counts + counts[_rc(ids, W)]
    bgp = (bgp + bgp[_rc(ids, W)]).astype(np.float32)
    expected = (bgp * np.float32(ltot)).astype(np.float32)
    z = (counts - expected) / np.sqrt(expected)
    seeds = np.argsort(-z, kind="stable")[:n_seeds].astype(np.int32)
    return counts.astype(np.int32), expected, bgp, seeds


@pytest.mark.parametrize("W", [6, 10])
def test_flat_tables_on_card_match_cpu(W, cuda):
    rng = np.random.default_rng(W)
    flat = rng.integers(0, 1000, size=(2, 4 ** W)).astype(np.float32)
    masks = rng.integers(0, 2, size=(3, W, 4)).astype(np.float32)
    for fn in ("sep_sum_flat", "all_marginals", "pair_marginals"):
        got = [getattr(tft, fn)(torch.from_numpy(flat).to(d)[:, None],
                                torch.from_numpy(masks).to(d), W).cpu()
               for d in (cuda, "cpu")]
        assert torch.equal(*got), fn
    v = [rng.uniform(0.05, 1, size=4 ** (k + 1)).astype(np.float32)
         for k in range(4)]
    for order in range(4):
        got = [tft.aggregate_double_strand_flat(tft.bg_prob_flat(
            [torch.from_numpy(x).to(d) for x in v], W, order), W).cpu()
            for d in (cuda, "cpu")]
        assert torch.equal(*got), order


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("score_type", [0, 1, 2])
@pytest.mark.parametrize("both", [True, False], ids=["both", "plus"])
def test_walks_on_card_match_cpu(both, score_type, wide, cuda):
    W = 8
    counts, expected, bgp, seeds = _walk_inputs(W, seed=score_type)
    outs = {}
    for d in (cuda, "cpu"):
        t = [torch.from_numpy(a).to(d) for a in (counts, expected, bgp,
                                                 seeds)]
        out = tcl.walks_program(
            *t, np.float32(1000), np.float32(5), W, both, score_type,
            wide=wide)
        outs[str(d)] = {k: (x.cpu().numpy() if torch.is_tensor(x) else x)
                        for k, x in out.items()}
    got, want = outs[str(cuda)], outs["cpu"]
    assert got["n_steps"] == want["n_steps"] >= 2
    assert bool(got["overflow"]) == bool(want["overflow"])
    for k in ("improved", "chosen_idx", "acc_idx", "acc_n", "chosen_counts",
              "acc_counts", "init_counts"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("chosen_expected", "chosen_bgp", "acc_expected",
              "init_expected", "init_bgp"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    for k in ("chosen_score", "acc_score", "init_score"):
        np.testing.assert_allclose(got[k], want[k], rtol=2e-6, atol=2e-5,
                                   err_msg=k)


def _mafk_walk_args(argv, tmp_path):
    """The device engine's run_walks call of one MafK job: (args,
    kwargs)."""
    calls = []
    real = engine.run_walks

    def run_walks(*a, **k):
        calls.append((a, k))
        return real(*a, **k)

    argv = [os.path.join(GOLDEN_DIR, "MafK.fasta"), *argv, "--engine", "tpu",
            "-o", str(tmp_path / "o.meme")]
    with pytest.MonkeyPatch.context() as m, \
            contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        m.setattr(engine, "run_walks", run_walks)
        assert main(argv) == 0
    (call,) = calls
    return call


@pytest.mark.parametrize("score", ["MUTUAL_INFO", "LOGPVAL"])
@pytest.mark.parametrize("strand", ["BOTH", "PLUS"])
@pytest.mark.parametrize("W", [8, 10, 12])
def test_climb_graph_is_the_eager_step(W, strand, score, cuda, tmp_path,
                                       monkeypatch):
    """The climb on the card replays its step from one CUDA graph
    (ops/climb._lockstep): on a MafK job's own tables and seeds, its
    trace is the eager step's bit for bit, and every step but the first
    is a replay."""
    (counts, expected, bgp, seeds, length, both, st, n_seq, pseudo), kw = \
        _mafk_walk_args(["-w", str(W), "--strand", strand,
                         "--optimization_score", score], tmp_path)
    assert counts.device.type == "cuda"
    ids = torch.as_tensor(np.asarray(seeds, np.int32), device=counts.device)

    def walks():
        with PhaseTimer().activate() as recorder:
            out = tcl.walks_program(counts, expected, bgp, ids,
                                    np.float32(n_seq), np.float32(pseudo),
                                    length, both, st, **kw)
        return out, recorder.counters["climb.graph_steps"]

    graph, replays = walks()
    monkeypatch.setattr(tcl, "_lockstep", lambda step, dev: step)
    eager, eager_replays = walks()
    assert graph["n_steps"] == eager["n_steps"] >= 2
    assert replays == graph["n_steps"] - 1 and eager_replays == 0
    assert graph.keys() == eager.keys()
    for k, x in graph.items():
        if torch.is_tensor(x):
            assert torch.equal(x, eager[k]), k


def test_climb_graph_beside_a_nccl_group(cuda, tmp_path):
    """The climb captures its graph while a NCCL process group lives in
    the process (its watchdog thread polls the card): the job's output
    is the job's without the group, and every step but the first is a
    replay."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    plain = _cell_job("w10", tmp_path)
    plain_meme = (tmp_path / "o.meme").read_bytes()
    tmh.init_multihost(f"localhost:{port}", 1, 0, timeout_s=120,
                       device=cuda)
    try:
        x = torch.ones(8, device=cuda)
        torch.distributed.all_reduce(x)
        counters = _cell_job("w10", tmp_path)
    finally:
        tmh.shutdown_multihost()
    assert (tmp_path / "o.meme").read_bytes() == plain_meme
    assert counters["climb.graph_steps"] == plain["climb.graph_steps"] > 0


def _job_seeds_are_the_host_stats(W, strand, tmp_path, monkeypatch):
    """A MafK job at the rule's end (as the cells run it): the stats
    program's bgp on the card is the host fold of the job's own
    background conditionals, its expected and z are
    ``base_stats_native``'s over that fold, bit for bit, and the prefix
    the seeds were walked over is the native zscore_sort_prefix's.
    Returns the job's stderr (``--timing``)."""
    from peng_motif_tpu_torch.native import (
        base_stats_native, bg_prob_table_native_fn,
        zscore_sort_prefix_indices)

    monkeypatch.setattr(thy, "count_on_host", RULE)
    seen = []
    real_stats, real_prefix = engine.stats_program, engine._seed_prefix

    def stats_program(state, length, order_k, order_max, both):
        st = real_stats(state, length, order_k, order_max, both)
        seen.append((state, order_k, both))
        return st

    def seed_prefix(st, zthr):
        prefix = real_prefix(st, zthr)
        seen.append((st, zthr, prefix))
        return prefix

    monkeypatch.setattr(engine, "stats_program", stats_program)
    monkeypatch.setattr(engine, "_seed_prefix", seed_prefix)
    err = io.StringIO()
    argv = [os.path.join(GOLDEN_DIR, "MafK.fasta"), "-w", str(W),
            "--strand", strand, "--engine", "tpu", "-o",
            str(tmp_path / "o.meme"), "--timing"]
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        assert main(argv) == 0
    assert engine.LAST_ENGINE_USED == "gpu"
    (state, order_k, both), (st, zthr, prefix) = seen
    assert st["z"].device.type == "cuda" and both == (strand == "BOTH")
    bgp = st["bgp"].cpu().numpy()
    want_bgp = bg_prob_table_native_fn(
        [v.cpu().numpy() for v in state.v[: order_k + 1]], W, order_k, both)
    np.testing.assert_array_equal(bgp.view(np.uint32),
                                  want_bgp.view(np.uint32))
    expected, z = base_stats_native(st["counts"].cpu().numpy(), bgp,
                                    state.ltot)
    for name, want in (("z", z), ("expected", expected)):
        got = st[name].cpu().numpy()
        assert got.dtype == np.float32, name
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32), err_msg=name)
    keep = int(np.count_nonzero(~(z < np.float32(zthr))))
    order = zscore_sort_prefix_indices(z, float(zthr))[: keep + 1]
    np.testing.assert_array_equal(prefix.ids, order)
    np.testing.assert_array_equal(prefix.z.view(np.uint32),
                                  z[order].view(np.uint32))
    np.testing.assert_array_equal(prefix.expected.view(np.uint32),
                                  expected[order].view(np.uint32))
    return err.getvalue()


@pytest.mark.parametrize("strand", ["BOTH", "PLUS"])
@pytest.mark.parametrize("W", [8])
def test_seeds_bgp_from_the_card_is_the_host_fold(W, strand, cuda, tmp_path,
                                                 monkeypatch):
    """Where the host sorts the whole z table (W <= 8), the seed selection
    fetches the stats program's z and expected from the card in one read,
    and they are the host's (_job_seeds_are_the_host_stats).  W 10 and
    12: test_seeds_z_and_prefix_from_the_card."""
    err = _job_seeds_are_the_host_stats(W, strand, tmp_path, monkeypatch)
    assert "[COUNT] seeds.card_partitions: 0\n" in err
    assert "[TIMING] count.seeds.fetch: " in err


@pytest.mark.parametrize("strand", ["BOTH", "PLUS"])
@pytest.mark.parametrize("W", [10, 12])
def test_seeds_z_and_prefix_from_the_card(W, strand, cuda, tmp_path,
                                          monkeypatch):
    """Past the host range the z-sort's large partitions run on the card
    (ops/seed_sort.py): the seeds' z, expected and prefix are the host's
    (_job_seeds_are_the_host_stats), after at least one partition on the
    card."""
    err = _job_seeds_are_the_host_stats(W, strand, tmp_path, monkeypatch)
    assert "[COUNT] seeds.card_partitions: 0" not in err
    assert "[COUNT] seeds.card_partitions: " in err
    assert "count.seeds.fetch" not in err


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("both", [True, False], ids=["both", "plus"])
def test_stats_and_adv_pwm_on_card_match_cpu(both, wide, cuda):
    W = 10
    rng = np.random.default_rng(3)
    # narrow: every sum below 2**24, where the f32 chain is exact
    counts = rng.integers(0, 60_000 if wide else 15,
                          size=4 ** W).astype(np.int32)
    fix_ids = rng.integers(0, 4 ** W, size=64).astype(np.int32)
    fix_dv = rng.integers(-2, 3, size=64).astype(np.int32)
    v = [rng.uniform(0.05, 1, size=4 ** (k + 1)).astype(np.float32)
         for k in range(3)]
    dig = rng.integers(0, 11, size=(20, W)).astype(np.int32)
    outs = {}
    for d in (cuda, "cpu"):
        st = engine.stats_program(
            engine.resident_state(counts, 5_000_000, fix_ids, fix_dv, v, d),
            W, 1, 2, both)
        pwm = engine.adv_pwm_program(torch.from_numpy(dig), st["counts"],
                                     st["bgp"][:4].contiguous(), 10, W, both,
                                     wide=wide)
        outs[str(d)] = [t.cpu() for t in list(st.values()) + [pwm]]
    for a, b in zip(outs[str(cuda)], outs["cpu"]):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def mafk_em_args(tmp_path_factory):
    """``args(W)``: the em_optimize_flat arguments of one MafK job at -w
    W on the card (its adv-PWMs, stats_program counts and bg_max, and the
    job's s, threshold and iteration cap), one job a width."""
    cache = {}

    def args(W):
        if W not in cache:
            calls = []
            real = engine.em_optimize_flat

            def em_optimize_flat(*a):
                calls.append(a)
                return real(*a)

            out = tmp_path_factory.mktemp("em") / "o.meme"
            argv = [os.path.join(GOLDEN_DIR, "MafK.fasta"), "-w", str(W),
                    "--engine", "tpu", "-o", str(out)]
            with pytest.MonkeyPatch.context() as m, \
                    contextlib.redirect_stdout(io.StringIO()), \
                    contextlib.redirect_stderr(io.StringIO()):
                m.setattr(engine, "em_optimize_flat", em_optimize_flat)
                assert main(argv) == 0
            (cache[W],) = calls
        return cache[W]

    return args


def _em_case(source, W, A, dev, mafk_em_args):
    """(pwms, counts, bg, s, thr, max_it) on ``dev``: a random table
    (Poisson counts with planted peaks, uniform bg) or MafK's own tables;
    MafK's adv-PWMs first, then random PWMs up to A motifs.  On the
    random table a batch's first motif is uniform: at W >= 10 it stops
    after one round while the others go on."""
    rng = np.random.default_rng(1000 * W + A)
    pwms = rng.dirichlet(np.ones(4), size=(A, W)).astype(np.float32)
    if source == "random":
        if A > 1:
            pwms[0] = 0.25
        n = 4 ** W
        counts = rng.poisson(20, size=n).astype(np.float32)
        counts[rng.integers(0, n, size=n // 512)] += 2000
        counts = torch.from_numpy(counts).to(dev)
        bg = torch.from_numpy(np.full(n, 2.0 / n, np.float32)).to(dev)
        return torch.from_numpy(pwms).to(dev), counts, bg, 1e4, 0.08, 10
    pwm0, counts, bg, s, thr, max_it, length = mafk_em_args(W)
    assert length == W and counts.device.type == "cuda"
    k = min(A, pwm0.shape[0])
    pwms = torch.cat([pwm0[:k].cpu(), torch.from_numpy(pwms[k:])])
    return pwms.to(dev), counts.to(dev), bg.to(dev), s, thr, max_it


@pytest.mark.parametrize("A", [1, 12, 16, 17])
@pytest.mark.parametrize("source", ["random", "mafk"])
@pytest.mark.parametrize("W", [8, 10, 12])
def test_em_on_card_matches_cpu(W, source, A, cuda, mafk_em_args):
    """The round kernel (csrc/em.cu) against the plain torch round on the
    CPU: the same iterations, PWM cells within 5e-6 (the marginals are
    summed in another order); two calls bit-identical (no float atomics);
    ``em.kernel_rounds`` and the wrapper's launches (two a round), and no
    histogram launch.  Where A > 1, a motif stops while others go on."""
    pwms, counts, bg, s, thr, max_it = _em_case(source, W, A, cuda,
                                                mafk_em_args)
    runs = []
    for _ in range(2):
        before, hist = tem.LAUNCHES, th.LAUNCHES
        with PhaseTimer().activate() as rec:
            runs.append(tem.em_optimize_flat(pwms, counts, bg, s, thr,
                                             max_it, W))
        rounds = int(runs[-1][1].max())
        assert rec.counters["em.kernel_rounds"] == rounds > 0
        assert rec.calls("em_round") == rounds
        assert tem.LAUNCHES - before == 2 * rounds
        assert th.LAUNCHES == hist
    (pwm, it), (again, it2) = runs
    assert torch.equal(pwm, again) and torch.equal(it, it2)
    want, want_it = tem.em_optimize_flat(pwms.cpu(), counts.cpu(), bg.cpu(),
                                         s, thr, max_it, W)
    np.testing.assert_array_equal(it.cpu().numpy(), want_it.numpy())
    np.testing.assert_allclose(pwm.cpu().numpy(), want.numpy(), rtol=0,
                               atol=5e-6)
    if A > 1:
        assert int(it.min()) < int(it.max())


@pytest.mark.parametrize("source", ["random", "mafk"])
@pytest.mark.parametrize("W", [10, 12])
def test_em_kernel_motifs_do_not_see_each_other(W, source, cuda,
                                                mafk_em_args):
    """A motif's PWM and iterations from the kernel are the same bits
    whatever motifs run beside it (every sum of the round is the motif's
    own): the first A of 17 motifs, run alone, are the 17-motif run's
    first rows."""
    pwms, counts, bg, s, thr, max_it = _em_case(source, W, 17, cuda,
                                                mafk_em_args)
    pwm, it = tem.em_optimize_flat(pwms, counts, bg, s, thr, max_it, W)
    for A in (1, 12, 16):
        sub, sub_it = tem.em_optimize_flat(pwms[:A], counts, bg, s, thr,
                                           max_it, W)
        assert torch.equal(sub, pwm[:A]) and torch.equal(sub_it, it[:A])


def test_em_zero_count_rows_give_nan_on_card(cuda):
    """A table of zero counts: every row 0/0, so every PWM cell NaN and
    every motif stops after one round, as in the plain round."""
    rng = np.random.default_rng(4)
    W = 4
    pwms = torch.from_numpy(
        rng.dirichlet(np.ones(4), size=(4, W)).astype(np.float32))
    counts = torch.zeros(4 ** W)
    bg = torch.full((4 ** W,), 2.0 / 4 ** W)
    got, got_it = tem.em_optimize_flat(pwms.to(cuda), counts.to(cuda),
                                       bg.to(cuda), 1e4, 0.08, 10, W)
    want, want_it = tem.em_optimize_flat(pwms, counts, bg, 1e4, 0.08, 10, W)
    assert torch.isnan(got).all() and torch.isnan(want).all()
    assert torch.equal(got_it.cpu(), want_it) and int(want_it.max()) == 1


def test_em_kernel_without_rounds_launches_nothing(cuda):
    """No motif, no iteration allowed, or a threshold no change exceeds
    (W = 4 <= 5.0): the PWMs come back as given with 0 iterations, as
    from the plain round, and nothing is launched or read."""
    rng = np.random.default_rng(5)
    W = 4
    pwms = torch.from_numpy(
        rng.dirichlet(np.ones(4), size=(3, W)).astype(np.float32))
    counts = torch.from_numpy(rng.poisson(20, size=4 ** W).astype(np.float32))
    bg = torch.full((4 ** W,), 2.0 / 4 ** W)
    for p, max_it, thr in ((pwms[:0], 10, 0.08), (pwms, 0, 0.08),
                           (pwms, 10, 5.0)):
        before = tem.LAUNCHES
        with PhaseTimer().activate() as rec:
            got, got_it = tem.em_optimize_flat(p.to(cuda), counts.to(cuda),
                                               bg.to(cuda), 1e4, thr, max_it,
                                               W)
        want, want_it = tem.em_optimize_flat(p, counts, bg, 1e4, thr, max_it,
                                             W)
        assert tem.LAUNCHES == before and rec.counters.get("syncs", 0) == 0
        assert rec.counters["em.kernel_rounds"] == 0
        assert torch.equal(got.cpu(), want) and torch.equal(got_it.cpu(),
                                                            want_it)
        assert torch.equal(want, p) and not want_it.any()


# -- the recorder's counters against the card's own account ----------------

# the benchmark cells' jobs (bench_port/traffic): MafK at -w 10 on the
# device engine, and -w 12 on it with the rule's host count
CELL_JOBS = {"w10": ["-w", "10"], "w12_tpu": ["-w", "12", "--engine", "tpu"]}


def _cell_job(name, tmp_path, *extra):
    """One MafK job of a cell's flags with --timing: its [COUNT] lines."""
    argv = [os.path.join(GOLDEN_DIR, "MafK.fasta"), *CELL_JOBS[name],
            "--timing", "-o", str(tmp_path / "o.meme"), *extra]
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        assert main(argv) == 0
    counters = {}
    for line in err.getvalue().splitlines():
        if line.startswith("[COUNT] "):
            key, value = line[8:].split(": ")
            counters[key] = int(value)
    return counters


@pytest.fixture
def planner_share(monkeypatch):
    """The count at the rule's end, as the cells run it."""
    monkeypatch.setattr(thy, "count_on_host", RULE)


@pytest.mark.parametrize("name", sorted(CELL_JOBS))
def test_syncs_are_the_sync_debug_warnings(name, cuda, planner_share,
                                           tmp_path):
    """Every point where the host waits for the card passes through the
    recorder's helpers: ``syncs`` equals the warnings of torch's sync
    debug mode over a warm job."""
    _cell_job(name, tmp_path)                 # builds, caches
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            counters = _cell_job(name, tmp_path)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # torch's own first call also warns that the mode is a prototype
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    sites = collections.Counter(
        f"{os.path.basename(w.filename)}:{w.lineno}" for w in syncs)
    assert counters["syncs"] == len(syncs), sites


@pytest.mark.parametrize("name", sorted(CELL_JOBS))
def test_h2d_counters_are_the_traced_copies(name, cuda, planner_share,
                                            tmp_path):
    """``h2d.copies`` and ``h2d.bytes`` equal the host-to-device copies
    of the job's device trace (--profile), in number and in bytes.  The
    profiler at times loses the device records of a job's first copies
    and kernels (the job's runtime calls are all there; seen with the
    profile at the phases alone too), so a trace may hold fewer copies,
    never more: up to four profiled jobs, one of them exact."""
    _cell_job(name, tmp_path)
    seen = []
    for k in range(4):
        counters = _cell_job(name, tmp_path, "--profile",
                             str(tmp_path / f"p{k}"))
        with open(tmp_path / f"p{k}" / "trace.json") as f:
            events = json.load(f)["traceEvents"]
        h2d = [e for e in events if e.get("cat") == "gpu_memcpy"
               and "HtoD" in e.get("name", "")]
        got = (len(h2d), sum(e["args"]["bytes"] for e in h2d))
        want = (counters["h2d.copies"], counters["h2d.bytes"])
        assert got[0] <= want[0] and got[1] <= want[1], (got, want)
        seen.append(got)
        if got == want:
            return
    pytest.fail(f"no trace held all {want} copies/bytes: {seen}")


def test_worker_spans_lie_in_their_parent_in_the_trace(cuda, planner_share,
                                                       tmp_path):
    """At -w 12 the rule counts MafK on the host, on the main thread: its
    span count.host reaches the --profile trace inside the interval of
    the range "count"."""
    _cell_job("w12_tpu", tmp_path)
    _cell_job("w12_tpu", tmp_path, "--profile", str(tmp_path / "p"))
    with open(tmp_path / "p" / "trace.json") as f:
        events = json.load(f)["traceEvents"]

    def ranges(name):               # host ranges (not their device copies)
        return [(e["ts"], e["ts"] + e["dur"]) for e in events
                if e.get("name") == name and e.get("ph") == "X"
                and e.get("cat") == "user_annotation"]

    (count,) = ranges("count")
    (host,) = ranges("count.host")
    assert count[0] <= host[0] < host[1] <= count[1]


# -- several cards: the mesh, the kernel on cuda:k, NCCL between cards ------


@pytest.fixture
def cards():
    """``cards(n)``: the mesh ``cuda:0 … cuda:n-1``; skips the test on a
    machine with fewer cards (decided here, when the test runs)."""
    def need(n):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            pytest.skip(f"needs {n} CUDA cards, the machine has {have}")
        return tuple(torch.device("cuda", k) for k in range(n))
    return need


def _zero_launches():
    th.LAUNCHES = 0
    th.TIER_LAUNCHES.update(shared=0, l2=0)
    th.DEVICE_LAUNCHES.clear()


@pytest.mark.parametrize("m", [2, 4])
def test_make_data_mesh_names_distinct_cards(m, cards):
    mesh = cards(m)
    assert make_data_mesh(m, "cuda") == mesh
    assert len({str(torch.cuda.get_device_properties(d).uuid)
                for d in mesh}) == m


@pytest.mark.parametrize("n_bins", [128, 4 ** 6, 4 ** 8, 4 ** 10, 4 ** 12])
def test_kernel_on_every_card(n_bins, cards):
    """The wrapper's device switch: the kernel launches on the card its
    inputs live on (counted there), on that card's stream, and agrees
    with the plain version and with card 0."""
    cards(2)
    ids, inc = _inputs(3_000_001, n_bins, seed=n_bins)
    want = None
    for d in make_data_mesh(None, "cuda"):         # every card
        ids_d = torch.from_numpy(ids).to(d)[1:]
        inc_d = torch.from_numpy(inc).to(d)[1:]
        before = th.DEVICE_LAUNCHES.get(d.index, 0)
        with torch.cuda.device(0):        # the current card is another
            got = th.histogram(ids_d, inc_d, n_bins)
        torch.cuda.synchronize(d)
        assert got.device == d
        assert th.DEVICE_LAUNCHES[d.index] == before + len(
            th.plan(n_bins, ids_d.numel()).ranges)
        assert torch.equal(got, th.histogram_plain(ids_d, inc_d, n_bins))
        want = got.cpu() if want is None else want
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("wire2", [False, True], ids=["mask", "wire2"])
def test_stream_count_sharded_over_cards(m, wire2, cards):
    """Shards on distinct cards, each card launching for both tables,
    the sums on cuda:0: identical to the same mesh size on the CPU."""
    mesh = cards(m)
    rng = np.random.default_rng(16 + m)
    if wire2:
        seqs = [rng.integers(1, 5, size=400).astype(np.uint8)
                for _ in range(300)]
    else:
        seqs = [rng.integers(0, 5, size=int(n)).astype(np.uint8)
                for n in rng.integers(3, 3000, size=200)]
    flat = np.concatenate(seqs)
    _zero_launches()
    _, lay, out = tsh.stream_count_sharded(seqs, 8, True, mesh,
                                           flat_codes=flat, bg_order=2)
    assert tsc.wire2_eligible(lay, int((flat == 0).sum())) == wire2
    assert th.DEVICE_LAUNCHES == {k: 2 for k in range(m)}
    assert all(t.device == mesh[0] for t in out)
    _, _, cpu = tsh.stream_count_sharded(seqs, 8, True,
                                         make_data_mesh(m, "cpu"),
                                         flat_codes=flat, bg_order=2)
    for a, b in zip(out, cpu):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("m", [2, 4])
def test_batch_and_bg_counts_over_cards(m, cards):
    mesh = cards(m)
    rng = np.random.default_rng(30 + m)
    codes = rng.integers(1, 5, size=(303, 640)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 0
    codes[4, :128] = np.tile(np.array([1, 3], dtype=np.uint8), 64)
    host = tcnt.CountJob(codes, 8, True, "cpu").finish()
    _zero_launches()
    got = tsh.count_patterns_sharded(codes, 8, True, mesh)
    assert th.DEVICE_LAUNCHES == {k: 1 for k in range(m)}
    np.testing.assert_array_equal(got[0], host[0])
    assert got[1] == host[1]
    full = tsh.count_device_full_sharded(codes, 8, True, mesh)
    cpu = tsh.count_device_full_sharded(codes, 8, True,
                                        make_data_mesh(m, "cpu"))
    for a, b in zip(full[:4], cpu[:4]):
        assert a.device == mesh[0] and torch.equal(a.cpu(), b)
    lengths = rng.integers(600, 641, size=codes.shape[0]).astype(np.int32)
    seqs = [codes[i, : lengths[i]] for i in range(codes.shape[0])]
    _zero_launches()
    bg = tsh.count_bg_kmers_sharded(codes, 2, mesh, lengths=lengths)
    assert th.DEVICE_LAUNCHES == {k: 3 for k in range(m)}
    for g, w in zip(bg, tbg.count_kmers(seqs, 2)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("m", [2, 4])
def test_count_phase_over_cards_stays_on_the_first(m, cards):
    """engine._count_phase over distinct cards: the resident table lives
    on cuda:0, stats_program completes it there to the host table, and
    nothing after the count allocates on the other cards."""
    from types import SimpleNamespace

    from peng_motif_tpu_torch.io.fasta import load_sequence_set

    mesh = cards(m)
    sset = load_sequence_set(os.path.join(GOLDEN_DIR, "synthetic_n.fasta"))
    peng = SimpleNamespace(
        sequence_set=sset,
        bg_model=tbg.BackgroundModel(sset.sequences, order=2,
                                     interpolate=True, defer=True))
    host, ltot, dev, fix_ids, fix_dv = engine._count_phase(
        peng, 8, True, mesh[0], mesh=mesh)
    assert dev.device == mesh[0]
    peaks = {}
    for d in mesh[1:]:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
        peaks[d] = torch.cuda.memory_allocated(d)
    st = engine.stats_program(
        engine.resident_state(dev, ltot, fix_ids, fix_dv, peng.bg_model.v,
                              mesh[0]), 8, 2, 2, True)
    assert st["counts"].device == mesh[0]
    np.testing.assert_array_equal(st["counts"].cpu().numpy(), host)
    for d, base in peaks.items():
        assert torch.cuda.max_memory_allocated(d) <= base, d


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("engine_flag", ["tpu", "exact"])
def test_cli_devices_over_cards(m, engine_flag, cards, tmp_path, capsys,
                                monkeypatch):
    """--devices m over distinct cards: every card launches, the MEME
    bytes and stdout equal the run without --devices; the exact engine
    (its count on the cards) stays byte-identical to golden."""
    cards(m)
    if engine_flag == "exact":
        monkeypatch.setenv("PENG_COUNT_HOST_MAX_BASES", "0")
    outs = {}
    for label, extra in (("mesh", ["--devices", str(m)]), ("single", [])):
        _zero_launches()
        meme = tmp_path / f"{label}.meme"
        capsys.readouterr()
        assert main([os.path.join(GOLDEN_DIR, "MafK.fasta"), "-w", "8",
                     "--device", "cuda", "--engine", engine_flag, "-o",
                     str(meme)] + extra) == 0
        if label == "mesh":
            # the device engine: both tables a card; the exact engine: the
            # batch count and three background tables a card
            assert th.DEVICE_LAUNCHES == {
                k: 2 if engine_flag == "tpu" else 4 for k in range(m)}
        outs[label] = (meme.read_bytes(), capsys.readouterr().out)
    assert outs["mesh"] == outs["single"]
    if engine_flag == "exact":
        with open(os.path.join(GOLDEN_DIR, "mafk_w8.meme"), "rb") as g:
            assert outs["mesh"][0] == g.read()


def _seeing(cards):
    """A child's environment that shows it only ``cards`` (indices among
    this process's cards)."""
    parent = os.environ.get("CUDA_VISIBLE_DEVICES")
    if parent:
        names = parent.split(",")
        cards = ",".join(names[int(c)] for c in cards.split(","))
    return dict(os.environ, CUDA_VISIBLE_DEVICES=cards, PYTHONPATH=REPO)


@pytest.mark.parametrize("procs,per", [(4, 1), (2, 2)], ids=["4x1", "2x2"])
def test_processes_over_nccl(procs, per, cards, tmp_path):
    """One process per card (or per two cards, --devices 2), each given
    its own cards by CUDA_VISIBLE_DEVICES as a launcher sets it: every
    rank reports backend nccl and counts on its own cards; process 0's
    MEME equals the single-process run's."""
    import re
    import subprocess
    import sys

    from peng_motif_tpu_torch.parallel.multihost import card_sets

    cards(procs * per)
    fasta = os.path.join(GOLDEN_DIR, "MafK.fasta")
    single = tmp_path / "single.meme"
    assert main([fasta, "-w", "10", "--device", "cuda", "--engine", "tpu",
                 "-o", str(single)]) == 0
    port = _free_port()
    out0 = tmp_path / "p0.meme"
    ps = [subprocess.Popen(
        [sys.executable, "-m", "peng_motif_tpu_torch", fasta, "-w", "10",
         "--device", "cuda", "--engine", "tpu", "--num-processes",
         str(procs), "--process-id", str(r), "--coordinator",
         f"localhost:{port}"]
        + (["--devices", str(per)] if per > 1 else [])
        + (["-o", str(out0)] if r == 0 else []),
        cwd=REPO, env=_seeing(s), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for r, s in enumerate(card_sets(procs * per, procs))]
    results = []
    try:
        for p in ps:
            out, err = p.communicate(timeout=300)
            results.append((p.returncode, out, err))
    finally:
        for p in ps:
            if p.poll() is None:
                p.kill()
                p.communicate()
    edges = []
    for r, (rc, out, err) in enumerate(results):
        assert rc == 0, err[-3000:]
        assert r == 0 or out == ""
        hit = re.search(
            rf"rank {r} of {procs} counted chunk rows \[(\d+), (\d+)\) on "
            rf"{per} x cuda, histogram launches [1-9]\d* .*backend nccl", err)
        assert hit, err[-3000:]
        edges.append((int(hit.group(1)), int(hit.group(2))))
    assert edges[0][0] == 0
    assert all(a[1] == b[0] for a, b in zip(edges, edges[1:]))
    assert out0.read_bytes() == single.read_bytes()


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("m", [2, 4])
def test_dryrun_multichip_over_cards(m, cards):
    cards(m)
    from peng_motif_tpu_torch.parallel.dryrun import dryrun_multichip

    _zero_launches()
    dryrun_multichip(m, "cuda")
    assert sorted(th.DEVICE_LAUNCHES) == list(range(m))
