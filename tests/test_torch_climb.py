"""The port's lockstep climb (peng_motif_tpu_torch/ops/climb.py) against
the reference package's JAX ``walks_program`` / ``run_walks`` /
``replay_walks`` on the same numpy inputs, made from a seed: a count
table with a planted motif over a random background.

Tolerances (tests/test_control_flow.py:223-228): the integer trace
fields (improved, chosen and accepted indices, accepted-row counts,
count aggregates), n_steps and overflow identical; expected and
background aggregates within 1e-6 relative (f32 tree sums in another
order); scores within 2e-6 relative + 2e-5 absolute.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peng_motif_tpu import engine_tpu as jengine
from peng_motif_tpu import pipeline as jpipeline
from peng_motif_tpu.ops import climb as jcl
from peng_motif_tpu_torch import engine as tengine
from peng_motif_tpu_torch import pipeline as tpipeline
from peng_motif_tpu_torch.ops import climb as tcl
from peng_motif_tpu_torch.ops import flat_tables as tft
from peng_motif_tpu_torch.utils.logging_utils import PhaseTimer

INT_KEYS = ("improved", "chosen_idx", "acc_idx", "acc_n", "chosen_counts",
            "acc_counts", "init_counts")
AGG_KEYS = ("chosen_expected", "chosen_bgp", "acc_expected",
            "init_expected", "init_bgp")
SCORE_KEYS = ("chosen_score", "acc_score", "init_score")


def _rc(ids, W):
    rc = np.zeros_like(ids)
    for p in range(W):
        rc |= (3 - ((ids >> (2 * p)) & 3)) << (2 * (W - 1 - p))
    return rc


def walk_inputs(W, seed, n_seeds=8, ltot=300_000):
    """(counts int32, expected f32, bgp f32, seed ids int32, n_sequences):
    a mirrored count table over a random background with a planted motif
    (every id within one mismatch of it enriched), seeds the top
    z-scores, and a sequence count that keeps the MI score off its
    saturation at every W."""
    rng = np.random.default_rng(seed)
    n = 4 ** W
    ids = np.arange(n)
    bgp = rng.uniform(0.5, 1.5, size=n)
    bgp = (bgp / bgp.sum()).astype(np.float32)
    expected = (bgp * np.float32(ltot)).astype(np.float32)
    counts = rng.poisson(expected).astype(np.int64)
    motif = rng.integers(0, 4, size=W)
    mism = np.zeros(n, dtype=np.int64)
    for p in range(W):
        mism += ((ids >> (2 * p)) & 3) != motif[p]
    counts += np.where(mism == 0, 400, np.where(mism == 1, 60, 0))
    counts = counts + counts[_rc(ids, W)]          # mirrored, both strands
    bgp = (bgp + bgp[_rc(ids, W)]).astype(np.float32)
    expected = (bgp * np.float32(ltot)).astype(np.float32)
    z = (counts - expected) / np.sqrt(expected)
    seeds = np.argsort(-z, kind="stable")[:n_seeds].astype(np.int32)
    n_seq = max(1000, 40 * ltot // n)
    return counts.astype(np.int32), expected, bgp, seeds, n_seq


def _jax_walks(inp, W, both, st, wide, **kw):
    counts, expected, bgp, seeds, n_seq = inp
    out = jcl.walks_program(
        jnp.asarray(counts), jnp.asarray(expected), jnp.asarray(bgp),
        jnp.asarray(seeds), jnp.ones(seeds.shape[0], bool),
        jnp.float32(n_seq), jnp.float32(n_seq // 200), W, both, st,
        wide=wide, **kw)
    return jax.device_get(out)


def _torch_walks(inp, W, both, st, wide, device="cpu", **kw):
    counts, expected, bgp, seeds, n_seq = inp
    t = [torch.from_numpy(a).to(device) for a in (counts, expected, bgp,
                                                  seeds)]
    out = tcl.walks_program(
        *t, np.float32(n_seq), np.float32(n_seq // 200), W, both, st,
        wide=wide, **kw)
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items()}


def assert_traces_match(got, want):
    assert int(got["n_steps"]) == int(want["n_steps"])
    assert bool(got["overflow"]) == bool(want["overflow"])
    for k in INT_KEYS:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k].astype(np.float64),
                                      want[k].astype(np.float64), err_msg=k)
    for k in AGG_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0,
                                   err_msg=k)
    for k in SCORE_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-6, atol=2e-5,
                                   err_msg=k)


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("score_type", [0, 1, 2])
@pytest.mark.parametrize("both", [True, False], ids=["both", "plus"])
@pytest.mark.parametrize("W", [4, 6, 8])
def test_walks_program_matches_reference(W, both, score_type, wide):
    inp = walk_inputs(W, seed=W * 10 + score_type)
    want = _jax_walks(inp, W, both, score_type, wide)
    got = _torch_walks(inp, W, both, score_type, wide)
    assert int(want["n_steps"]) >= 2   # the walks really climb
    assert_traces_match(got, want)


@pytest.mark.parametrize("score_type", [0, 2])
@pytest.mark.parametrize("both", [True, False], ids=["both", "plus"])
@pytest.mark.parametrize("W", [4, 8])
def test_walks_on_cpu_take_no_graph(W, both, score_type):
    """Off CUDA the step runs as it is, every step: the climb's counter
    climb.graph_steps reads 0, a span a step, and the trace is the
    reference's (the CUDA graph's replay is held against this eager
    step on the card, tests/test_torch_gpu.py)."""
    def step():
        pass

    assert tcl._lockstep(step, torch.device("cpu")) is step
    inp = walk_inputs(W, seed=W * 10 + score_type)
    want = _jax_walks(inp, W, both, score_type, False)
    with PhaseTimer().activate() as recorder:
        got = _torch_walks(inp, W, both, score_type, False)
    assert recorder.counters["climb.graph_steps"] == 0
    assert recorder.calls("step") == int(got["n_steps"]) >= 2
    assert_traces_match(got, want)


@pytest.mark.parametrize("score_type", [0, 2])
@pytest.mark.parametrize("both", [True, False], ids=["both", "plus"])
def test_walks_off_cuda_take_the_dense_step(both, score_type, monkeypatch):
    """Off CUDA the climb's aggregates are the dense torch step's: no
    kernel library asked for, the counters climb.kernel_steps and
    climb.ids registered as 0, and the trace that of the dense step
    asked for by name."""
    def no_library():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(tcl, "build_kernels", no_library)
    W = 6
    inp = walk_inputs(W, seed=W * 10 + score_type)
    with PhaseTimer().activate() as recorder:
        got = _torch_walks(inp, W, both, score_type, False)
    want = _torch_walks(inp, W, both, score_type, False, plain=True)
    assert recorder.counters["climb.kernel_steps"] == 0
    assert recorder.counters["climb.ids"] == 0
    assert recorder.calls("step") == int(got["n_steps"]) >= 2
    assert got.keys() == want.keys()
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_climb_kernel_takes_only_cuda_tensors(device, monkeypatch):
    """The kernel's wrapper refuses tensors off CUDA before it asks for
    the library; walks_program never hands it one."""
    def no_library():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(tcl, "build_kernels", no_library)
    W, S = 4, 3
    t = dict(device=device)
    args = (torch.zeros((4 ** W, 4), **t),
            torch.zeros((S, W), dtype=torch.int64, **t),
            torch.ones(S, dtype=torch.bool, **t),
            torch.zeros(tcl.LETTER_TABLE.shape, dtype=torch.int32, **t),
            torch.zeros((S, 3, tcl.MAXSIM * W), **t),
            torch.zeros(1, dtype=torch.int64, **t))
    with pytest.raises(ValueError, match="needs a CUDA device"):
        tcl.climb_aggregates(*args, W, True)


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("both", [True, False], ids=["both", "plus"])
@pytest.mark.parametrize("W", [6, 8])
def test_seed_aggregates_are_the_full_aggregate(W, both, wide):
    """The seeds' aggregates as the climb takes them, one entry of each
    table a seed (its canonical id's under both strands), are the dense
    contraction's over the masked tables bit for bit; the seeds include
    palindromes."""
    counts, expected, bgp, seeds, _ = walk_inputs(W, seed=W + 3,
                                                  n_seeds=32)
    ids = np.arange(4 ** W)
    pal = ids[ids == _rc(ids, W)][:4]
    seeds = torch.from_numpy(np.concatenate([seeds, pal]).astype(np.int32))
    agg = torch.float64 if wide else torch.float32
    tabs = [torch.from_numpy(a) for a in (counts, expected, bgp)]
    stack = torch.stack([t.to(agg) for t in tabs])
    if both:
        stack = torch.where(tft.canonical_mask(W, "cpu"), stack,
                            torch.zeros((), dtype=agg))
    digits0 = torch.stack([(seeds.to(torch.int64) >> (2 * p)) & 3
                           for p in range(W)], dim=-1)
    masks = torch.from_numpy(np.asarray(tcl.IUPAC_MASKS)).to(agg)
    want = tcl._aggregate_full(stack, masks[digits0][:, None], W, both)
    got = tcl._seed_aggregates(tabs, seeds, W, both, agg)
    assert got.dtype == want.dtype == agg
    assert torch.equal(got, want)


@pytest.mark.parametrize("score_type", [0, 2])
@pytest.mark.parametrize("both", [True, False], ids=["both", "plus"])
def test_replay_outcomes_match_reference(both, score_type):
    W = 8
    counts, expected, bgp, seeds, n_seq = walk_inputs(W, seed=3,
                                                      n_seeds=12)
    # a repeated and a neighbouring seed exercise the seen-set kills
    seeds = np.concatenate([seeds, seeds[:1], seeds[1:2] ^ 1])
    j_trace = jcl.run_walks(
        jnp.asarray(counts), jnp.asarray(expected), jnp.asarray(bgp), seeds,
        W, both, score_type, n_seq, n_seq // 200, max_seeds=len(seeds))
    with PhaseTimer().activate() as recorder:
        t_trace = tcl.run_walks(
            torch.from_numpy(counts), torch.from_numpy(expected),
            torch.from_numpy(bgp), seeds, W, both, score_type, n_seq,
            n_seq // 200)
    assert t_trace.improved.shape[1] == len(seeds)
    assert recorder.calls("step") == t_trace.n_steps
    j_out = jcl.replay_walks(j_trace, seeds, W)
    t_out = tcl.replay_walks(t_trace, seeds, W)
    assert len(j_out) == len(t_out) == len(seeds)
    assert any(not o.emitted for o in t_out)
    for a, b in zip(t_out, j_out):
        assert a.emitted == b.emitted
        np.testing.assert_array_equal(a.final_digits, b.final_digits)
        assert a.final_counts == b.final_counts
        np.testing.assert_allclose(a.final_expected, b.final_expected,
                                   rtol=1e-6)
        np.testing.assert_allclose(a.final_bgp, b.final_bgp, rtol=1e-6)
        assert len(a.rows) == len(b.rows)
        for ra, rb in zip(a.rows, b.rows):
            np.testing.assert_array_equal(ra[0], rb[0])
            assert ra[1] == rb[1]
            np.testing.assert_allclose(ra[2], rb[2], rtol=1e-6)
            np.testing.assert_allclose(ra[3], rb[3], rtol=2e-6, atol=2e-5)


def _climb_text(pipeline, engine, climb, trace, seeds, W):
    """One package's climb section (engine._replay_climb) on a trace."""
    peng = pipeline.Peng.__new__(pipeline.Peng)
    peng.out = io.StringIO()
    engine._replay_climb(peng, None, climb.WalkTrace(*trace), seeds, W)
    return peng.out.getvalue()


@pytest.mark.parametrize("score_type", [0, 2])
@pytest.mark.parametrize("both", [True, False], ids=["both", "plus"])
@pytest.mark.parametrize("W", [4, 6, 8, 10])
def test_replay_text_matches_reference(W, both, score_type):
    """The native replay's climb text, byte for byte the reference
    engine's, on the port's walks; the counter climb.replay_rows reads
    the rows printed."""
    counts, expected, bgp, seeds, n_seq = walk_inputs(W, seed=W, n_seeds=10)
    seeds = np.concatenate([seeds, seeds[:1], seeds[1:2] ^ 1])
    trace = tcl.run_walks(
        torch.from_numpy(counts), torch.from_numpy(expected),
        torch.from_numpy(bgp), seeds, W, both, score_type, n_seq,
        n_seq // 200)
    want = _climb_text(jpipeline, jengine, jcl, trace, seeds, W)
    with PhaseTimer().activate() as recorder:
        got = _climb_text(tpipeline, tengine, tcl, trace, seeds, W)
    assert got == want
    assert "removed" in got
    rows = sum(line.startswith("\t") for line in got.splitlines())
    assert recorder.counters["climb.replay_rows"] == rows


def test_argmin_tie_takes_first_minimum():
    """A uniform table: every mutant that widens one position to the same
    IUPAC letter has the same aggregate and score, so each step's minimum
    is tied across positions; the earliest candidate must win (strict <,
    as jnp.argmin)."""
    W = 6
    n = 4 ** W
    counts = np.full(n, 40, dtype=np.int32)
    expected = np.full(n, 10.0, dtype=np.float32)
    bgp = np.full(n, 1.0 / n, dtype=np.float32)
    seeds = np.array([0, 1365, 2730], dtype=np.int32)
    inp = (counts, expected, bgp, seeds, 1000)
    for st in (1, 2):
        want = _jax_walks(inp, W, False, st, False)
        got = _torch_walks(inp, W, False, st, False)
        assert_traces_match(got, want)
        # the step-0 choice sits at position 0 although positions 1..W-1
        # offer the same letter with the same score
        assert (got["chosen_idx"][0] < tcl.MAXSIM).all()
        assert got["improved"][0].all()


@pytest.mark.parametrize("cap,value", [("MAX_STEPS", 1), ("ACC_CAP", 0)])
def test_overflow_raises(cap, value, monkeypatch):
    W = 6
    counts, expected, bgp, seeds, n_seq = walk_inputs(W, seed=61)
    monkeypatch.setattr(tcl, cap, value)
    with pytest.raises(tcl.ClimbOverflow, match=f"{cap}={value}"):
        tcl.run_walks(torch.from_numpy(counts), torch.from_numpy(expected),
                      torch.from_numpy(bgp), seeds, W, True, 2, n_seq,
                      n_seq // 200)


def test_overflow_flag_matches_reference():
    W = 6
    inp = walk_inputs(W, seed=62)
    want = _jax_walks(inp, W, True, 2, False, max_steps=2)
    got = _torch_walks(inp, W, True, 2, False, max_steps=2)
    assert bool(want["overflow"])
    assert_traces_match(got, want)


def test_walks_wide_matches_narrow():
    """wide=True (f64 aggregation chain for ltot >= 2**24) produces the
    narrow chain's decisions and aggregates where both are exact (all
    sums < 2**24): the port's mirror of the reference test
    (tests/test_control_flow.py:195-228)."""
    rng = np.random.default_rng(5)
    W = 6
    counts = rng.integers(0, 4_000, size=4 ** W).astype(np.int32)
    expected = (rng.random(4 ** W) * 50).astype(np.float32)
    bgp = (rng.random(4 ** W) * 1e-4).astype(np.float32)
    ids = rng.integers(0, 4 ** W, size=7).astype(np.int32)
    inp = (counts, expected, bgp, ids, 500)
    a = _torch_walks(inp, W, True, 0, False)
    b = _torch_walks(inp, W, True, 0, True)
    for k in ("improved", "chosen_idx", "acc_n"):
        np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(a["chosen_counts"],
                                  b["chosen_counts"].astype(np.float32))
    np.testing.assert_allclose(a["chosen_expected"], b["chosen_expected"],
                               rtol=1e-6)
    np.testing.assert_allclose(a["chosen_score"], b["chosen_score"],
                               rtol=2e-6, atol=2e-5)


def test_no_seeds():
    W = 4
    counts, expected, bgp, _, _ = walk_inputs(W, seed=7)
    trace = tcl.run_walks(torch.from_numpy(counts),
                          torch.from_numpy(expected), torch.from_numpy(bgp),
                          [], W, True, 2, 1000, 5)
    assert trace.n_steps == 0 and not trace.overflow
    assert tcl.replay_walks(trace, [], W) == []


def test_cli_reports_climb_overflow(monkeypatch, caplog, tmp_path):
    """A walk past MAX_STEPS is reported, naming the bound, and the run
    falls back to the exact engine, as the reference engine does
    (engine_tpu.py:1141-1142): exit 0 with the golden output."""
    import logging
    import os

    from conftest import GOLDEN_DIR
    from peng_motif_tpu_torch import engine
    from peng_motif_tpu_torch.cli import main

    monkeypatch.setattr(tcl, "MAX_STEPS", 1)
    caplog.set_level(logging.INFO, logger="peng_motif_tpu_torch")
    out = tmp_path / "o.meme"
    rc = main([os.path.join(GOLDEN_DIR, "MafK_100seqs.fasta"), "-w", "8",
               "--device", "cpu", "--engine", "tpu", "-o", str(out)])
    assert rc == 0
    assert "MAX_STEPS=1" in caplog.text
    assert engine.LAST_ENGINE_USED == "exact"
    with open(os.path.join(GOLDEN_DIR, "mafk100_w8.meme"), "rb") as g:
        assert out.read_bytes() == g.read()
