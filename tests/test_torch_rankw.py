"""The port's rank-W tensor ops and ``graft_entry.entry()`` against the
reference package's, on the CPU, from the same numpy inputs (made from a
seed).

Tolerances, per function:

* ``ops/encoding`` helpers, ``count_patterns_device``, the integer sums
  of ``aggregate_batch``: identical;
* ``bg_prob_table`` / ``aggregate_double_strand``: bit-equal to the
  reference package's and to the port's flat tables reshaped (one f32
  rounding per factor, in position order);
* ``stats.expected_counts``: bit-equal (one IEEE multiply);
  ``zscores``: 5e-7 relative (XLA's CPU code does not round the square
  root and the division as two IEEE ops: 39% of the cells sit one ulp
  off); ``log_pvalues``: 2e-6 relative to the size of the formula's
  terms, |result| + n + mu (f32 ``log`` may differ by an ulp between the
  libraries, and the result is a difference of terms of size n), ``inf``
  and 0 positions identical;
* the float sums of ``aggregate_batch``: 1e-6 relative (the contraction
  order within an axis is the libraries' own);
* rank-W ``em_optimize``: iteration counts identical, PWM cells within
  1e-6 absolute (``sum`` fixes no order);
* ``entry()``: z-scores within 1e-6 relative + 1e-6 absolute of
  ``jax.jit(_forward)`` (XLA may contract the strand add and the
  multiply by ltot into one fma).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax
import jax.numpy as jnp

from peng_motif_tpu import alphabets as al
from peng_motif_tpu.ops import bgprobs as jbg
from peng_motif_tpu.ops import counting as jcnt
from peng_motif_tpu.ops import em as jem
from peng_motif_tpu.ops import encoding as jenc
from peng_motif_tpu.ops import iupac_sum as jis
from peng_motif_tpu.ops import stats as jst
from peng_motif_tpu_torch import graft_entry
from peng_motif_tpu_torch.ops import bgprobs as tbg
from peng_motif_tpu_torch.ops import counting as tcnt
from peng_motif_tpu_torch.ops import em as tem
from peng_motif_tpu_torch.ops import encoding as tenc
from peng_motif_tpu_torch.ops import flat_tables as tft
from peng_motif_tpu_torch.ops import histogram as th
from peng_motif_tpu_torch.ops import iupac_sum as tis
from peng_motif_tpu_torch.ops import stats as tst

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


# -- ops/encoding ------------------------------------------------------------


@pytest.mark.parametrize("W", [1, 2, 3, 4, 5, 6])
def test_rc_permute_equals_rc_gather(W):
    """rc_permute is the gather by rc_ids_flat, bit for bit, on ints and
    floats, and equals the reference's and the numpy mirror."""
    rng = np.random.default_rng(W)
    n = 4 ** W
    for table in (np.arange(n, dtype=np.int32),
                  rng.standard_normal(n).astype(np.float32)):
        got = tenc.to_flat(tenc.rc_permute(tenc.to_tensor(_t(table), W)))
        want = _t(table)[tenc.rc_ids_flat(W, CPU)]
        assert torch.equal(got, want)
        ref = np.asarray(jenc.rc_permute(
            jenc.to_tensor(jnp.asarray(table), W))).reshape(-1)
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(tenc.np_rc_permute(table, W), ref)


def test_rc_permute_matches_scalar_revcomp():
    W = 5
    n = 4 ** W
    permuted = tenc.rc_permute(tenc.to_tensor(
        torch.arange(n, dtype=torch.int32), W)).reshape(-1).numpy()
    for pid in [0, 1, 5, 100, n - 1, 777]:
        assert permuted[pid] == al.base_revcomp_id(pid, W)


@pytest.mark.parametrize("W", [2, 4, 5])
def test_canonical_mask_and_id_tensors(W):
    mask = tenc.canonical_mask(W, CPU)
    assert mask.shape == (4,) * W and mask.dtype == torch.bool
    flat = mask.reshape(-1).numpy()
    for pid in range(4 ** W):
        assert flat[pid] == (pid <= al.base_revcomp_id(pid, W))
    np.testing.assert_array_equal(flat, np.asarray(
        jenc.canonical_mask(W)).reshape(-1))
    assert torch.equal(mask.reshape(-1), tenc.canonical_mask_flat(W, CPU))
    ids = tenc.pattern_ids_tensor(W, CPU)
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(),
                                  np.asarray(jenc.pattern_ids_tensor(W)))
    np.testing.assert_array_equal(tenc.rc_ids_tensor(W, CPU).numpy(),
                                  np.asarray(jenc.rc_ids_tensor(W)))
    assert torch.equal(tenc.rc_ids_tensor(W, CPU).reshape(-1).long(),
                       tenc.rc_ids_flat(W, CPU))


def test_axis_of_pos_and_reshapes():
    W = 4
    for pos in range(W):
        assert tenc.axis_of_pos(W, pos) == jenc.axis_of_pos(W, pos)
    flat = torch.arange(4 ** W)
    t = tenc.to_tensor(flat, W)
    # position p has factor 4**p and sits on axis W-1-p
    assert int(t[3, 2, 1, 0]) == 0 + 1 * 4 + 2 * 16 + 3 * 64
    assert torch.equal(tenc.to_flat(t), flat)


# -- ops/stats -----------------------------------------------------------------


def _stats_inputs(seed, n=4 ** 6):
    rng = np.random.default_rng(seed)
    counts = rng.poisson(8, size=n).astype(np.int32)
    counts[rng.integers(0, n, size=40)] = 0
    counts[rng.integers(0, n, size=40)] += 500
    bgp = rng.uniform(0.2, 3, size=n).astype(np.float32)
    bgp /= bgp.sum()
    return counts, bgp


def test_expected_and_zscores_match_reference():
    counts, bgp = _stats_inputs(0)
    ltot = 34_567
    want_e = np.asarray(jst.expected_counts(jnp.asarray(bgp),
                                            jnp.float32(ltot)))
    for lt in (ltot, torch.tensor(ltot, dtype=torch.int64)):
        got_e = tst.expected_counts(_t(bgp), lt)
        assert got_e.dtype == torch.float32
        np.testing.assert_array_equal(got_e.numpy(), want_e)
    want_z = np.asarray(jst.zscores(jnp.asarray(counts), jnp.asarray(want_e)))
    got_z = tst.zscores(_t(counts), _t(want_e))
    np.testing.assert_allclose(got_z.numpy(), want_z, rtol=5e-7, atol=0)
    np.testing.assert_allclose(
        got_z.numpy(),
        (counts.astype(np.float32) - want_e) / np.sqrt(want_e), rtol=5e-7,
        atol=0)


def test_log_pvalues_match_reference():
    counts, bgp = _stats_inputs(1)
    expected = (bgp * np.float32(30_000)).astype(np.float32)
    want = np.asarray(jst.log_pvalues(jnp.asarray(counts),
                                      jnp.asarray(expected)))
    got = tst.log_pvalues(_t(counts), _t(expected)).numpy()
    assert got.dtype == np.float32 and not np.isnan(got).any()
    # counts == 0 -> +inf (the body is NaN there and masked), and the
    # "not enriched" zeros, at the same positions
    np.testing.assert_array_equal(np.isinf(got), counts == 0)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(got == 0, want == 0)
    assert (got == 0).any() and (got < 0).any()
    fin = np.isfinite(want)
    size = np.abs(want[fin]) + counts[fin] + expected[fin]
    assert (np.abs(got[fin] - want[fin]) <= 2e-6 * size).all()


def test_log_pvalues_differ_from_the_binary_promotion_form_only_slightly():
    """flat_tables.base_log_pvalues_ref is the same formula with the
    reference binary's f64 promotion points: close, not merged."""
    counts, bgp = _stats_inputs(2)
    expected = (bgp * np.float32(30_000)).astype(np.float32)
    a = tst.log_pvalues(_t(counts), _t(expected)).numpy()
    b = tft.base_log_pvalues_ref(_t(counts), _t(expected)).numpy()
    np.testing.assert_array_equal(np.isinf(a), np.isinf(b))
    fin = np.isfinite(a)
    np.testing.assert_allclose(a[fin], b[fin], rtol=1e-4, atol=1e-4)


# -- ops/bgprobs -------------------------------------------------------------


def _v(rng, order):
    return [rng.uniform(0.05, 1, size=4 ** (k + 1)).astype(np.float32)
            for k in range(order + 1)]


@pytest.mark.parametrize("W,order", [(4, 0), (4, 2), (6, 2), (5, 1), (3, 2),
                                     (6, 3)])
def test_bg_prob_table_bit_equal(W, order):
    rng = np.random.default_rng(10 * W + order)
    v = _v(rng, order)
    got = tbg.bg_prob_table([_t(x) for x in v], W, order)
    assert got.shape == (4,) * W and got.dtype == torch.float32
    want = np.asarray(jbg.bg_prob_table([jnp.asarray(x) for x in v], W,
                                        order))
    np.testing.assert_array_equal(got.numpy(), want)
    # the reference's explicit host fold and the port's flat table
    np.testing.assert_array_equal(got.reshape(-1).numpy(),
                                  jbg.host_bg_prob_flat(v, W, order))
    flat = tft.bg_prob_flat([_t(x) for x in v], W, order)
    assert torch.equal(got.reshape(-1), flat)


@pytest.mark.parametrize("W", [2, 4, 5])
def test_aggregate_double_strand_bit_equal(W):
    rng = np.random.default_rng(W)
    p = rng.uniform(0, 1, size=4 ** W).astype(np.float32)
    got = tbg.aggregate_double_strand(tenc.to_tensor(_t(p), W))
    want = np.asarray(jbg.aggregate_double_strand(
        jenc.to_tensor(jnp.asarray(p), W)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.reshape(-1).numpy(), jbg.host_aggregate_double_strand_flat(p, W))
    assert torch.equal(got.reshape(-1),
                       tft.aggregate_double_strand_flat(_t(p), W))


# -- ops/iupac_sum ---------------------------------------------------------------


def test_mask_tables_match_reference():
    digits = [0, 4, 10, 7, 3]
    np.testing.assert_array_equal(tis.masks_from_iupac_digits(digits),
                                  jis.masks_from_iupac_digits(digits))
    pid = al.string_to_iupac_id("CTRAN")
    np.testing.assert_array_equal(tis.masks_from_iupac_id(pid, 5),
                                  jis.masks_from_iupac_id(pid, 5))


@pytest.mark.parametrize("W", [2, 4, 5])
def test_sep_sum_matches_reference_and_flat(W):
    rng = np.random.default_rng(W)
    n = 4 ** W
    masks = rng.integers(0, 2, size=(5, W, 4)).astype(np.int32)
    counts = rng.integers(0, 50_000, size=n).astype(np.int32)
    got = tis._sep_sum(tenc.to_tensor(_t(counts), W), _t(masks))
    assert got.dtype == torch.int32 and got.shape == (5,)
    for b in range(5):
        want = int(jis._sep_sum(jenc.to_tensor(jnp.asarray(counts), W),
                                jnp.asarray(masks[b])))
        assert int(got[b]) == want
    # the port's flat contraction on the same table (f64: exact)
    flat = tft.sep_sum_flat(_t(counts).double(), _t(masks).double(), W)
    assert torch.equal(got.double(), flat)
    tabs = rng.uniform(0, 10, size=(2, n)).astype(np.float32)
    gotf = tis._float_sums(_t(tabs).reshape((2,) + (4,) * W),
                           _t(masks).float())
    assert gotf.shape == (5, 2) and gotf.dtype == torch.float32
    for b in range(5):
        want = np.asarray(jis._float_sums(
            jnp.asarray(tabs).reshape((2,) + (4,) * W),
            jnp.asarray(masks[b], dtype=jnp.float32)))
        np.testing.assert_allclose(gotf[b].numpy(), want, rtol=1e-6)
    flatf = tft.sep_sum_flat(_t(tabs)[None], _t(masks).float()[:, None], W)
    np.testing.assert_allclose(gotf.numpy(), flatf.numpy(), rtol=1e-6)


@pytest.mark.parametrize("both", [True, False], ids=["both", "plus"])
@pytest.mark.parametrize("W", [4, 6])
def test_aggregate_batch_matches_reference(W, both):
    rng = np.random.default_rng(100 + W)
    n = 4 ** W
    counts = rng.integers(0, 3000, size=n).astype(np.int32)
    tabs = rng.uniform(0, 5, size=(2, n)).astype(np.float32)
    if both:
        canon = np.asarray(jenc.canonical_mask_flat(W))
        counts = counts * canon
        tabs = tabs * canon
    digits = rng.integers(0, 11, size=(9, W))
    masks = al.IUPAC_MASKS[digits].astype(np.int32)
    got_c, got_f = tis.aggregate_batch(
        tenc.to_tensor(_t(counts), W), _t(tabs).reshape((2,) + (4,) * W),
        _t(masks), both)
    want_c, want_f = jis.aggregate_batch(
        jenc.to_tensor(jnp.asarray(counts), W),
        jnp.asarray(tabs).reshape((2,) + (4,) * W), jnp.asarray(masks), both)
    assert got_c.dtype == torch.int32 and got_f.dtype == torch.float32
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=1e-6)
    # brute force: distinct canonical ids matched by the pattern or its
    # reverse complement
    ids = np.arange(n)
    dg = (ids[:, None] >> (2 * np.arange(W))) & 3
    for b in range(9):
        m = masks[b]
        hit = m[np.arange(W), dg].all(axis=1)
        if both:
            rc = np.asarray(jenc.rc_ids_flat(W))
            hit = hit | hit[rc]
        assert int(got_c[b]) == int(counts[hit].sum())


def test_sep_sum_int32_contraction_is_exact_past_f32():
    """Sums past 2**24 stay exact: the contraction never goes through
    floats."""
    W = 4
    counts = np.full(4 ** W, 100_001, dtype=np.int32)
    masks = np.ones((1, W, 4), dtype=np.int32)
    got = tis._sep_sum(tenc.to_tensor(_t(counts), W), _t(masks))
    assert int(got[0]) == 100_001 * 4 ** W > 2 ** 24


# -- ops/em, rank-W ----------------------------------------------------------------


@pytest.mark.parametrize("W", [4, 6])
def test_rank_w_em_matches_reference(W):
    rng = np.random.default_rng(W)
    n = 4 ** W
    counts = rng.poisson(20, size=n).astype(np.float32)
    counts[rng.integers(0, n, size=20)] += 2000
    bg = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    bg /= bg.sum()
    pwms = rng.dirichlet(np.ones(4), size=(7, W)).astype(np.float32)
    # two motifs that stop at once (threshold above any change), the
    # rest run on: finished motifs stay frozen
    for thr, max_it in ((0.08, 10), (0.5, 10), (0.0, 3)):
        got, it = tem.em_optimize(
            _t(pwms), tenc.to_tensor(_t(counts), W),
            tenc.to_tensor(_t(bg), W), 1e4, thr, max_it, W)
        want, want_it = jem.em_optimize(
            jnp.asarray(pwms), jenc.to_tensor(jnp.asarray(counts), W),
            jenc.to_tensor(jnp.asarray(bg), W), 1e4, thr, max_it, W)
        assert it.dtype == torch.int32
        np.testing.assert_array_equal(it.numpy(), np.asarray(want_it))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
        flat, flat_it = tem.em_optimize_flat(_t(pwms), _t(counts), _t(bg),
                                             1e4, thr, max_it, W)
        np.testing.assert_array_equal(it.numpy(), flat_it.numpy())
        # the port's two forms: different sums, the engine's tolerance
        np.testing.assert_allclose(got.numpy(), flat.numpy(), rtol=0,
                                   atol=5e-6)


def test_rank_w_em_helpers_match_reference():
    W = 4
    rng = np.random.default_rng(3)
    pwm = rng.dirichlet(np.ones(4), size=W).astype(np.float32)
    got = tem._pwm_product(_t(pwm), W)
    want = np.asarray(jem._pwm_product(jnp.asarray(pwm), W))
    np.testing.assert_array_equal(got.numpy(), want)
    r = rng.uniform(0, 1, size=(4,) * W).astype(np.float32)
    got_s = tem._axis_sums(_t(r), W)
    want_s = np.asarray(jem._axis_sums(jnp.asarray(r), W))
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=1e-6)
    # batched: a leading motif axis
    gb = tem._axis_sums(_t(np.stack([r, 2 * r])), W)
    np.testing.assert_allclose(gb[1].numpy(), 2 * want_s, rtol=1e-6)


# -- ops/counting.count_patterns_device ------------------------------------


def _pad(seqs):
    out = np.zeros((len(seqs), max(len(s) for s in seqs)), dtype=np.uint8)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = s
    return out


@pytest.mark.parametrize("W", [6, 10])
@pytest.mark.parametrize("both", [True, False], ids=["both", "plus"])
def test_count_patterns_device_matches_reference(W, both):
    """The reference's W=10 device-count case (tests/test_counting.py)
    and the entry point's width: counts and ltot identical, ltot a 0-d
    tensor (no host sync), nothing launched on a CPU tensor."""
    rng = np.random.default_rng(11)
    seqs = [rng.integers(0, 5, size=rng.integers(12, 120)).astype(np.uint8)
            for _ in range(9)]
    codes = _pad(seqs)
    before = th.LAUNCHES
    got, ltot = tcnt.count_patterns_device(_t(codes), W, both)
    assert th.LAUNCHES == before
    assert isinstance(ltot, torch.Tensor) and ltot.ndim == 0
    assert got.dtype == torch.int32 and got.shape == (4 ** W,)
    want, want_ltot = jcnt.count_patterns_device(jnp.asarray(codes), W, both)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(ltot) == int(want_ltot)


# -- graft_entry ---------------------------------------------------------------------


def _reference_entry():
    spec = importlib.util.spec_from_file_location(
        "reference_graft_entry", os.path.join(REPO, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_matches_reference_forward():
    ref = _reference_entry()
    fn, args = graft_entry.entry()
    ref_fn, ref_args = ref.entry()
    assert len(args) == len(ref_args) == 4
    for a, b in zip(args, ref_args):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    got = fn(*args, device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.float32
    assert got.shape == (4 ** 6,)
    want = np.asarray(jax.jit(ref_fn)(*ref_args))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # tensors in, another width
    got8 = fn(*(torch.from_numpy(a) for a in args), length=8, device="cpu")
    want8 = np.asarray(jax.jit(ref_fn, static_argnames="length")(
        *ref_args, length=8))
    np.testing.assert_allclose(got8.numpy(), want8, rtol=1e-6, atol=1e-6)


def test_entry_defaults_to_the_card():
    """Without ``device`` the function runs on the card, and says so
    where there is none; it never falls back to the CPU."""
    from peng_motif_tpu_torch.device import DeviceUnavailable

    fn, args = graft_entry.entry()
    if torch.cuda.is_available():
        assert fn(*args).device.type == "cuda"
    else:
        with pytest.raises(DeviceUnavailable):
            fn(*args)


def test_dryrun_is_reexported():
    from peng_motif_tpu_torch.parallel import dryrun

    assert graft_entry.dryrun_multichip is dryrun.dryrun_multichip


@pytest.mark.parametrize("where,cards,want", [("cuda", 4, 4), ("cuda", 2, 2),
                                              ("cuda", 1, 1), ("cpu", 1, 4)])
def test_dryrun_mesh_size_follows_the_card_count(where, cards, want,
                                                 monkeypatch):
    """``python -m peng_motif_tpu_torch.graft_entry cuda`` runs
    dryrun_multichip over every card there is, as the reference's runs
    over every device; on the CPU over four virtual shards."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert graft_entry.dryrun_mesh_size(where) == want


def test_graft_entry_main_on_the_cpu():
    import subprocess
    import sys

    r = subprocess.run(
        [sys.executable, "-m", "peng_motif_tpu_torch.graft_entry", "cpu"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "entry ok: (4096,) cpu" in r.stdout
    assert "dryrun_multichip(4, cpu) ok" in r.stdout
