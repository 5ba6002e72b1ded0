"""The port's stats, adv-PWM and EM programs
(peng_motif_tpu_torch/engine.py, ops/em.py) against the reference
package's JAX ``stats_program``, ``adv_pwm_program`` and
``em_optimize_flat`` on the same numpy inputs, made from a seed and
handed to both packages through ``engine.resident_state``'s arrays.

Tolerances: the fixed-up counts exact; bgp, expected and bg_max
bit-identical (one correctly rounded f32 multiply per step, same order)
to the reference's flat_tables functions and to its jitted
stats_program — except that on the CPU, XLA contracts the last factor
multiply of the reverse-complement term into the strand add
(fma(p[rc], f[rc], p'[id]), one rounding instead of two), so for both
strands the jitted program's bgp may sit one f32 ulp off the host fold
the port reproduces, and its expected (bgp * ltot) two (ROADMAP
Queue C);
adv-PWMs bit-identical (integer sums, then one f64 division); EM PWMs
within 5e-6 with identical iteration counts (the responsibility sums are
f32 tree sums whose order differs between the packages) — also on a
4**10 table of 5.1e7 counts, the size at which both packages' device EM
sits 1e-4 and more from the native EM's ascending f32 fold
(test_em_at_corpus_scale_matches_reference prints that distance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peng_motif_tpu import engine_tpu as jeng
from peng_motif_tpu.ops import em as jem
from peng_motif_tpu.ops import flat_tables as jft
from peng_motif_tpu_torch import engine as teng
from peng_motif_tpu_torch.native import em_optimize_native
from peng_motif_tpu_torch.ops import em as tem
from peng_motif_tpu_torch.ops import histogram as th
from peng_motif_tpu_torch.utils.logging_utils import PhaseTimer


def _count_state(W, seed, order):
    """(counts, ltot, fix_ids, fix_dv, v): a mirrored-count-like table,
    a sparse fix-up with repeated ids and zero padding, and per-order
    conditional background tables."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 5_000, size=4 ** W).astype(np.int32)
    fix_ids = np.zeros(1024, dtype=np.int32)
    fix_dv = np.zeros(1024, dtype=np.int32)
    fix_ids[:40] = rng.integers(0, 4 ** W, size=40)
    fix_ids[40:44] = fix_ids[:4]
    fix_dv[:44] = rng.integers(-3, 4, size=44)
    v = []
    for k in range(order + 1):
        t = rng.uniform(0.1, 1.0, size=(4 ** k, 4))
        v.append((t / t.sum(axis=1, keepdims=True)).ravel().astype(
            np.float32))
    ltot = int(counts.sum() // 2) + 12_345
    return counts, ltot, fix_ids, fix_dv, v


@pytest.mark.parametrize("both", [True, False], ids=["both", "plus"])
@pytest.mark.parametrize("W,order_k,order_max", [(4, 0, 0), (6, 2, 2),
                                                 (6, 1, 3), (8, 2, 3)])
def test_stats_program_matches_reference(W, order_k, order_max, both):
    counts, ltot, fix_ids, fix_dv, v = _count_state(W, W + order_max,
                                                    order_max)
    want = jeng.stats_program(
        jnp.asarray(counts), tuple(jnp.asarray(x) for x in v),
        jnp.int32(ltot), jnp.asarray(fix_ids), jnp.asarray(fix_dv),
        jnp.zeros(4 ** W, jnp.uint16), W, order_k, order_max, both)
    state = teng.resident_state(counts, ltot, fix_ids, fix_dv, v, "cpu")
    got = {k: t.numpy() for k, t in
           teng.stats_program(state, W, order_k, order_max, both).items()}
    want = {k: np.asarray(a) for k, a in want.items()}
    np.testing.assert_array_equal(got["counts"], want["counts"])
    # the reference's functions, applied one by one (no XLA fusion)
    vj = [jnp.asarray(x) for x in v]
    for key, order in (("bgp", order_k), ("bg_max", order_max)):
        ref = jft.bg_prob_flat(vj, W, order)
        if both:
            ref = jft.aggregate_double_strand_flat(ref, W)
        ref = np.asarray(ref)
        np.testing.assert_array_equal(got[key], ref, err_msg=key)
        if key == "bgp":
            np.testing.assert_array_equal(
                got["expected"], ref * np.float32(ltot))
    for key, max_ulps in (("bgp", 1), ("expected", 2), ("bg_max", 1)):
        if both:
            ulps = np.abs(got[key].view(np.int32).astype(np.int64)
                          - want[key].view(np.int32))
            assert ulps.max() <= max_ulps, key
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # the resident table itself is not modified by the fix-up
    np.testing.assert_array_equal(state.counts.numpy(), counts)


def _adv_inputs(seed=6, W=6, hi=60_000, bg0=None):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, hi, size=4 ** W).astype(np.int32)
    dig = rng.integers(0, 11, size=(4, W)).astype(np.int32)
    if bg0 is None:
        bg0 = np.full(4, 0.25, np.float32)
    return counts, dig, bg0


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("both", [True, False], ids=["both", "plus"])
@pytest.mark.parametrize("case", ["uniform_bg", "skewed_bg"])
def test_adv_pwm_matches_reference(case, both, wide):
    """The inputs of tests/test_control_flow.py::
    test_adv_pwm_wide_matches_narrow, and a skewed background."""
    bg0 = (None if case == "uniform_bg"
           else np.array([0.31, 0.19, 0.21, 0.29], np.float32))
    counts, dig, bg0 = _adv_inputs(bg0=bg0)
    W = dig.shape[1]
    want = np.asarray(jeng.adv_pwm_program(
        jnp.asarray(dig), jnp.asarray(counts), jnp.asarray(bg0), 10, W, both,
        wide=wide))
    got = teng.adv_pwm_program(
        torch.from_numpy(dig), torch.from_numpy(counts),
        torch.from_numpy(bg0), 10, W, both, wide=wide).numpy()
    np.testing.assert_array_equal(got, want)


def test_adv_pwm_wide_matches_narrow():
    counts, dig, bg0 = _adv_inputs()
    W = dig.shape[1]
    a, b = (teng.adv_pwm_program(
        torch.from_numpy(dig), torch.from_numpy(counts),
        torch.from_numpy(bg0), 10, W, True, wide=w).numpy()
        for w in (False, True))
    np.testing.assert_array_equal(a, b)


def _em_inputs(W=6, seed=11):
    """A count table with a planted motif, the strand-aggregated uniform
    background, and four start PWMs: the planted motif sharpened, the
    same blurred, a random PWM and a PWM of an absent motif."""
    rng = np.random.default_rng(seed)
    n = 4 ** W
    ids = np.arange(n)
    motif = rng.integers(0, 4, size=W)
    mism = np.zeros(n, dtype=np.int64)
    for p in range(W):
        mism += ((ids >> (2 * p)) & 3) != motif[p]
    counts = rng.poisson(30, size=n) + np.where(mism == 0, 3000,
                                                np.where(mism == 1, 200, 0))
    counts = counts.astype(np.float32)
    bg = np.full(n, 2.0 / n, np.float32)
    pwms = np.full((4, W, 4), 0.05, np.float32)
    pwms[0, np.arange(W), motif] = 0.85
    pwms[1] = 0.25
    pwms[1, np.arange(W), motif] = 0.4
    pwms[2] = rng.dirichlet(np.ones(4), size=W)
    pwms[3, np.arange(W), (motif + 2) % 4] = 0.85
    pwms = pwms / pwms.sum(axis=-1, keepdims=True)
    return pwms.astype(np.float32), counts, bg


@pytest.mark.parametrize("max_it,thr", [(10, 0.08), (4, 0.08), (10, 0.5),
                                        (0, 0.08)])
def test_em_matches_reference(max_it, thr):
    pwms, counts, bg = _em_inputs()
    W = pwms.shape[1]
    want_pwm, want_it = (np.asarray(x) for x in jem.em_optimize_flat(
        jnp.asarray(pwms), jnp.asarray(counts), jnp.asarray(bg), 1e4, thr,
        max_it, W))
    got_pwm, got_it = tem.em_optimize_flat(
        torch.from_numpy(pwms), torch.from_numpy(counts),
        torch.from_numpy(bg), 1e4, thr, max_it, W)
    np.testing.assert_array_equal(got_it.numpy(), want_it)
    np.testing.assert_allclose(got_pwm.numpy(), want_pwm, rtol=0, atol=5e-6)
    if (max_it, thr) == (10, 0.08):
        # one motif stops early, one runs to max_iterations
        assert got_it.min() < max_it and got_it.max() == max_it


def test_em_zero_count_rows_give_nan_in_both():
    pwms, counts, bg = _em_inputs(W=4)
    counts[:] = 0
    want_pwm, want_it = (np.asarray(x) for x in jem.em_optimize_flat(
        jnp.asarray(pwms), jnp.asarray(counts), jnp.asarray(bg), 1e4, 0.08,
        10, 4))
    got_pwm, got_it = tem.em_optimize_flat(
        torch.from_numpy(pwms), torch.from_numpy(counts),
        torch.from_numpy(bg), 1e4, 0.08, 10, 4)
    assert np.isnan(want_pwm).all() and np.isnan(got_pwm.numpy()).all()
    np.testing.assert_array_equal(got_it.numpy(), want_it)


def test_em_no_motifs():
    _, counts, bg = _em_inputs(W=4)
    pwm, it = tem.em_optimize_flat(torch.zeros((0, 4, 4)),
                                   torch.from_numpy(counts),
                                   torch.from_numpy(bg), 1e4, 0.08, 10, 4)
    assert pwm.shape == (0, 4, 4) and it.shape == (0,)


def test_em_off_cuda_is_the_plain_round_and_launches_nothing(monkeypatch):
    """On CPU tensors em_optimize_flat is the plain torch round: the same
    bits as em_optimize_flat_plain, no kernel library asked for, no
    launch, and ``em.kernel_rounds`` registered as 0."""
    pwms, counts, bg = _em_inputs()
    W = pwms.shape[1]

    def no_library():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(tem, "build_kernels", no_library)
    before = (tem.LAUNCHES, th.LAUNCHES)
    args = (torch.from_numpy(pwms), torch.from_numpy(counts),
            torch.from_numpy(bg), 1e4, 0.08, 10, W)
    with PhaseTimer().activate() as rec:
        got, got_it = tem.em_optimize_flat(*args)
    want, want_it = tem.em_optimize_flat_plain(*args)
    assert torch.equal(got, want) and torch.equal(got_it, want_it)
    assert (tem.LAUNCHES, th.LAUNCHES) == before
    assert rec.counters["em.kernel_rounds"] == 0
    assert rec.calls("em_round") == int(got_it.max()) > 0


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_em_kernel_takes_only_cuda_tensors(device):
    """The kernel's wrapper refuses a tensor off CUDA before it asks for
    the library; the dispatcher never hands it one."""
    pwms, counts, bg = _em_inputs()
    with pytest.raises(ValueError, match="needs a CUDA device"):
        tem.em_optimize_flat_kernel(
            torch.from_numpy(pwms).to(device),
            torch.from_numpy(counts).to(device),
            torch.from_numpy(bg).to(device), 1e4, 0.08, 10, pwms.shape[1])


def _em_inputs_at_scale(W=10, planted=8, total=51_000_000, seed=23):
    """A 4**W table at the 51.2-Mbase corpus's scale: ``total`` counts
    drawn multinomially, a planted 8-mer (at offset 1 of the W positions)
    raised tenfold with its one-mismatch neighbours raised by half; the
    uniform strand-aggregated background; four start PWMs as in
    :func:`_em_inputs`."""
    rng = np.random.default_rng(seed)
    n = 4 ** W
    ids = np.arange(n)
    motif = rng.integers(0, 4, size=W)
    mism = np.zeros(n, dtype=np.int64)
    for p in range(1, 1 + planted):
        mism += ((ids >> (2 * p)) & 3) != motif[p]
    weight = np.where(mism == 0, 10.0, np.where(mism == 1, 1.5, 1.0))
    counts = rng.multinomial(total, weight / weight.sum()).astype(np.float32)
    bg = np.full(n, 2.0 / n, np.float32)
    pwms = np.full((4, W, 4), 0.05, np.float32)
    pwms[0, np.arange(W), motif] = 0.85
    pwms[1] = 0.25
    pwms[1, np.arange(W), motif] = 0.4
    pwms[2] = rng.dirichlet(np.ones(4), size=W)
    pwms[3, np.arange(W), (motif + 2) % 4] = 0.85
    pwms = pwms / pwms.sum(axis=-1, keepdims=True)
    return pwms.astype(np.float32), counts, bg


def test_em_at_corpus_scale_matches_reference(capsys):
    """At ltot ~ 5.1e7 on a 4**10 table the port's EM still agrees with
    the reference package's device EM (same iteration counts, cells
    within 5e-6): what separates the device engine from the exact engine
    at this scale is the f32 summation order that both device EMs share
    against the native EM's ascending fold, not a fault of the port.  The
    native EM's distance on the same table is printed, not asserted."""
    pwms, counts, bg = _em_inputs_at_scale()
    W = pwms.shape[1]
    assert 5.0e7 < counts.sum() < 5.2e7
    want_pwm, want_it = (np.asarray(x) for x in jem.em_optimize_flat(
        jnp.asarray(pwms), jnp.asarray(counts), jnp.asarray(bg), 1e4, 0.08,
        10, W))
    got_pwm, got_it = tem.em_optimize_flat(
        torch.from_numpy(pwms), torch.from_numpy(counts),
        torch.from_numpy(bg), 1e4, 0.08, 10, W)
    got_pwm = got_pwm.numpy()
    np.testing.assert_array_equal(got_it.numpy(), want_it)
    np.testing.assert_allclose(got_pwm, want_pwm, rtol=0, atol=5e-6)
    native = em_optimize_native(pwms, counts, bg, 1e4, 0.08, 10, n_threads=2)
    with capsys.disabled():
        print(f"\nEM at 4**{W}, {int(counts.sum())} counts, iterations "
              f"{want_it.tolist()}: port vs reference device EM max cell "
              f"difference {np.abs(got_pwm - want_pwm).max():.3g}; native "
              f"EM vs reference device EM {np.abs(native - want_pwm).max():.3g}"
              f"; native EM vs port {np.abs(native - got_pwm).max():.3g}")
