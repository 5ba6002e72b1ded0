"""The port's flat-table operations (peng_motif_tpu_torch/ops/flat_tables.py)
against the reference package's JAX functions on the same numpy inputs,
made from a seed.

Tolerances: contractions of integer tables with 0/1 masks are exact
(every partial sum is an integer below 2**24); bg_prob_flat and
aggregate_double_strand_flat are bit-identical (one correctly rounded
f32 operation per step, same order); the score functions agree within
2e-6 relative (f64 libm last-ulps, rounded to f32), as in
tests/test_flat_tables.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peng_motif_tpu.ops import flat_tables as jft
from peng_motif_tpu_torch.ops import flat_tables as tft


def _int_table(rng, shape):
    return rng.integers(0, 1000, size=shape).astype(np.float32)


def _masks(rng, shape):
    return rng.integers(0, 2, size=shape).astype(np.float32)


def _both(fn_j, fn_t, *arrays, **kw):
    j = np.asarray(fn_j(*[jnp.asarray(a) for a in arrays], **kw))
    t = fn_t(*[torch.from_numpy(a) for a in arrays], **kw).numpy()
    return j, t


@pytest.mark.parametrize("W", [2, 4, 6])
@pytest.mark.parametrize("fn", ["sep_sum_flat", "all_marginals",
                                "pair_marginals"])
def test_contractions_exact(fn, W):
    rng = np.random.default_rng(W)
    flat = _int_table(rng, 4 ** W)
    masks = _masks(rng, (W, 4))
    j, t = _both(getattr(jft, fn), getattr(tft, fn), flat, masks, length=W)
    assert j.shape == t.shape
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("W", [2, 4, 6])
def test_contractions_batched_tables_exact(W):
    """Leading table dims ([G, 4**W], as EM and the climb's stacked
    tables use them)."""
    rng = np.random.default_rng(10 + W)
    flat = _int_table(rng, (3, 4 ** W))
    masks = _masks(rng, (W, 4))
    for fn in ("sep_sum_flat", "all_marginals", "pair_marginals"):
        j, t = _both(getattr(jft, fn), getattr(tft, fn), flat, masks,
                     length=W)
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("W", [4, 6])
def test_batched_masks_match_per_mask_reference(W):
    """Masks with a leading motif dim [M, W, 4] (adv-PWM, the climb's
    seed aggregates) equal one reference call per mask set."""
    rng = np.random.default_rng(20 + W)
    flat = _int_table(rng, 4 ** W)
    masks = _masks(rng, (5, W, 4))
    for fn in ("sep_sum_flat", "all_marginals", "pair_marginals"):
        t = getattr(tft, fn)(torch.from_numpy(flat),
                             torch.from_numpy(masks), W).numpy()
        for i in range(masks.shape[0]):
            j = np.asarray(getattr(jft, fn)(jnp.asarray(flat),
                                            jnp.asarray(masks[i]), W))
            np.testing.assert_array_equal(t[i], j)


def test_contractions_f64():
    rng = np.random.default_rng(30)
    W = 4
    flat = rng.integers(0, 2 ** 40, size=4 ** W).astype(np.float64)
    masks = _masks(rng, (W, 4)).astype(np.float64)
    got = tft.all_marginals(torch.from_numpy(flat), torch.from_numpy(masks),
                            W).numpy()
    ids = np.arange(4 ** W)
    for p in range(W):
        for a in range(4):
            w = np.ones(4 ** W)
            for q in range(W):
                if q != p:
                    w *= masks[q][(ids >> (2 * q)) & 3]
            sel = ((ids >> (2 * p)) & 3) == a
            assert got[p, a] == (flat * w)[sel].sum()


@pytest.mark.parametrize("W,order", [(4, 0), (4, 1), (6, 2), (6, 3),
                                     (5, 3)])
def test_bg_prob_flat_bit_identical(W, order):
    rng = np.random.default_rng(40 + order)
    v = [rng.uniform(0.05, 1.0, size=4 ** (j + 1)).astype(np.float32)
         for j in range(order + 1)]
    j = np.asarray(jft.bg_prob_flat([jnp.asarray(x) for x in v], W, order))
    t = tft.bg_prob_flat([torch.from_numpy(x) for x in v], W, order).numpy()
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("W", [3, 4, 6])
def test_aggregate_double_strand_bit_identical(W):
    rng = np.random.default_rng(50 + W)
    p = rng.uniform(0.0, 1.0, size=4 ** W).astype(np.float32)
    j = np.asarray(jft.aggregate_double_strand_flat(jnp.asarray(p), W))
    t = tft.aggregate_double_strand_flat(torch.from_numpy(p), W).numpy()
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("W", [3, 4])
def test_rc_canonical_gather(W):
    rng = np.random.default_rng(60 + W)
    np.testing.assert_array_equal(tft.rc_ids(W, "cpu").numpy(),
                                  np.asarray(jft.rc_ids(W)))
    np.testing.assert_array_equal(tft.canonical_mask(W, "cpu").numpy(),
                                  np.asarray(jft.canonical_mask(W)))
    x = rng.normal(size=(2, 4 ** W)).astype(np.float32)
    np.testing.assert_array_equal(
        tft.rc_gather(torch.from_numpy(x), W).numpy(),
        np.asarray(jft.rc_gather(jnp.asarray(x), W)))


def _score_inputs(seed, n=512):
    rng = np.random.default_rng(seed)
    obs = rng.integers(0, 3000, size=n).astype(np.float32)
    obs[:8] = [0, 1, 5, 6, 7, 0, 2, 3]
    exp_ = rng.uniform(0.01, 1500, size=n).astype(np.float32)
    exp_[8:16] = obs[8:16]           # obs == exp
    exp_[16:24] = obs[16:24] * 2.0   # obs < exp
    return obs, exp_, rng


def _close(t, j, rtol=2e-6):
    t, j = np.asarray(t), np.asarray(j)
    assert t.dtype == j.dtype == np.float32
    np.testing.assert_array_equal(np.isinf(t), np.isinf(j))
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    fin = np.isfinite(j)
    np.testing.assert_allclose(t[fin], j[fin], rtol=rtol, atol=0)


def test_entropy_f():
    rng = np.random.default_rng(70)
    p = rng.uniform(1e-6, 1 - 1e-6, size=256).astype(np.float32)
    j, t = _both(jft._entropy_f, tft._entropy_f, p)
    _close(t, j)


@pytest.mark.parametrize("n_seq", [100, 5000])
def test_mutual_information_score(n_seq):
    obs, exp_, _ = _score_inputs(71)
    j = jft.mutual_information_score(jnp.asarray(obs), jnp.asarray(exp_),
                                     jnp.float32(n_seq))
    t = tft.mutual_information_score(torch.from_numpy(obs),
                                     torch.from_numpy(exp_), n_seq)
    _close(t, j)


@pytest.mark.parametrize("pseudo", [0, 25])
def test_enrichment_score(pseudo):
    obs, exp_, _ = _score_inputs(72)
    j = jft.enrichment_score(jnp.asarray(obs), jnp.asarray(exp_),
                             jnp.float32(pseudo))
    t = tft.enrichment_score(torch.from_numpy(obs), torch.from_numpy(exp_),
                             pseudo)
    _close(t, j)


def test_iupac_zscore_and_log_pvalue():
    obs, exp_, rng = _score_inputs(73)
    bsum = rng.uniform(10, 20, size=obs.shape).astype(np.float32)
    jz = jft.iupac_zscore(jnp.asarray(obs), jnp.asarray(exp_))
    tz = tft.iupac_zscore(torch.from_numpy(obs), torch.from_numpy(exp_))
    _close(tz, jz)
    j = jft.iupac_log_pvalue(jnp.asarray(obs), jnp.asarray(exp_), jz,
                             jnp.asarray(bsum))
    t = tft.iupac_log_pvalue(torch.from_numpy(obs), torch.from_numpy(exp_),
                             torch.from_numpy(np.array(jz)),
                             torch.from_numpy(bsum))
    _close(t, j)


def test_base_log_pvalues_ref():
    obs, exp_, _ = _score_inputs(74)
    counts = obs.astype(np.int32)
    j, t = _both(jft.base_log_pvalues_ref, tft.base_log_pvalues_ref,
                 counts, exp_)
    _close(t, j)


@pytest.mark.parametrize("score_type", [0, 1, 2])
def test_optimization_scores(score_type):
    obs, exp_, rng = _score_inputs(75 + score_type)
    bsum = rng.uniform(10, 20, size=obs.shape).astype(np.float32)
    j = jft.optimization_scores(score_type, jnp.asarray(obs),
                                jnp.asarray(exp_), jnp.float32(2000),
                                jnp.float32(10), jnp.asarray(bsum))
    t = tft.optimization_scores(score_type, torch.from_numpy(obs),
                                torch.from_numpy(exp_), 2000, 10,
                                torch.from_numpy(bsum))
    _close(t, j)


@pytest.mark.parametrize("score_type", [0, 1, 2])
def test_base_optimization_scores(score_type):
    obs, exp_, rng = _score_inputs(78 + score_type)
    logp = rng.uniform(-50, 0, size=obs.shape).astype(np.float32)
    j = jft.base_optimization_scores(score_type, jnp.asarray(obs),
                                     jnp.asarray(exp_), jnp.asarray(logp),
                                     jnp.float32(800), jnp.float32(4))
    t = tft.base_optimization_scores(score_type, torch.from_numpy(obs),
                                     torch.from_numpy(exp_),
                                     torch.from_numpy(logp), 800, 4)
    _close(t, j)


def test_scores_on_f64_aggregates():
    """The wide climb hands the score functions f64 count sums."""
    obs, exp_, rng = _score_inputs(81)
    obs64 = obs.astype(np.float64)
    bsum = rng.uniform(10, 20, size=obs.shape).astype(np.float32)
    for st in (0, 1, 2):
        j = jft.optimization_scores(st, jnp.asarray(obs64), jnp.asarray(exp_),
                                    jnp.float32(2000), jnp.float32(10),
                                    jnp.asarray(bsum))
        t = tft.optimization_scores(st, torch.from_numpy(obs64),
                                    torch.from_numpy(exp_), 2000, 10,
                                    torch.from_numpy(bsum))
        _close(t, j)
