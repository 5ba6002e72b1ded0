"""Flat-layout device table operations on torch tensors.

Counterpart of ``peng_motif_tpu/ops/flat_tables.py``.  Every 4**W table
is a flat ``[4**W]`` tensor.  Position p of a pattern id is the
little-endian base-4 digit with factor ``4**p`` (reference id layout:
src/base_pattern.h:20-29), so a row-major reshape
``[4**W] -> (4**(W-1-p), 4, 4**p)`` exposes position p as the middle
axis; every contraction below works through such reshapes.

Core primitives:

* :func:`sep_sum_flat` — full contraction with one mask per position
  (the IUPAC aggregation inner product, reference:
  src/iupac_pattern.cpp:410-473 re-expressed as a separable sum).
* :func:`all_marginals` — for every position p, the contraction over
  all *other* positions.
* :func:`pair_marginals` — marginals leaving a (p, W-1-p) position pair
  uncontracted (the double-strand dedup term of a single-position
  mutant differs from its mother at p and its mirror).
* :func:`bg_prob_flat` — the background-probability DP (reference:
  src/base_pattern.cpp:285-325) as W broadcast multiplies in the
  reference's left-to-right factor order: each factor is one correctly
  rounded f32 multiply, so entries are bit-equal to the host fold.
* the score formulas, with the reference binary's float32-storage /
  float64-transcendental promotion points.

Masks may carry leading batch dims (``[..., W, 4]``); they broadcast
against the table's leading dims.  Contractions run at the tables'
dtype: f32 (TF32 off, device.resolve_device) or f64, never lower, so
integer count sums stay exact.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from . import encoding
from ..utils.logging_utils import upload

F32 = torch.float32
F64 = torch.float64


# ---------------------------------------------------------------------------
# reshape-based contractions
# ---------------------------------------------------------------------------


def contract_pos(flat: torch.Tensor, pos: int,
                 mask: torch.Tensor) -> torch.Tensor:
    """Contract position ``pos`` of a flat table with a length-4 mask.

    flat: [..., 4**t] over live positions 0..t-1; mask: [..., 4].
    Returns [..., 4**(t-1)].
    """
    n = flat.shape[-1]
    lo = 4 ** pos
    hi = n // (4 * lo)
    x = flat.reshape(flat.shape[:-1] + (hi, 4, lo))
    out = torch.einsum("...hml,...m->...hl", x, mask.to(flat.dtype))
    return out.reshape(out.shape[:-2] + (n // 4,))


def sep_sum_flat(flat: torch.Tensor, masks: torch.Tensor,
                 length: int) -> torch.Tensor:
    """Full separable contraction: sum_id flat[id] * prod_p masks[p][digit_p].

    flat: [..., 4**W]; masks: [..., W, 4] (masks[..., p, :] applies to
    position p).  Contracts from the highest position down.
    """
    res = flat
    for pos in range(length - 1, -1, -1):
        res = contract_pos(res, pos, masks[..., pos, :])
    return res.reshape(res.shape[:-1])


def all_marginals(flat: torch.Tensor, masks: torch.Tensor,
                  length: int) -> torch.Tensor:
    """Single-position marginals of a mask-weighted table.

    Returns marg [..., W, 4] with
      marg[..., p, a] = sum over ids with digit_p == a of
                        flat[id] * prod_{q != p} masks[..., q, digit_q].
    Top-down prefix partials: contract positions W-1..t, then finish
    each marginal by contracting the remaining low block.
    """
    masks = masks.to(flat.dtype)
    margs = [None] * length
    part = flat  # live positions 0..t-1
    for t in range(length, 0, -1):
        p = t - 1
        n = part.shape[-1]
        v = part.reshape(part.shape[:-1] + (4, n // 4))
        low = v
        for q in range(p - 1, -1, -1):
            m = low.shape[-1]
            x = low.reshape(low.shape[:-2] + (4, 4, m // 4))
            low = torch.einsum("...amq,...m->...aq", x, masks[..., q, :])
        margs[p] = low.reshape(low.shape[:-2] + (4,))
        part = torch.einsum("...mq,...m->...q", v, masks[..., p, :])
    return torch.stack(margs, dim=-2)


def pair_marginals(flat: torch.Tensor, masks: torch.Tensor,
                   length: int) -> torch.Tensor:
    """Marginals leaving position pairs (i, W-1-i) uncontracted.

    Returns pm [..., W//2, 4, 4] with
      pm[..., i, a, b] = sum over ids with digit_i == a, digit_{W-1-i} == b
                         of flat[id] * prod_{q not in {i, W-1-i}} masks[q][dq].
    Requires even ``length`` (reference: src/Global.cpp:103-106).
    """
    assert length % 2 == 0
    masks = masks.to(flat.dtype)
    out = []
    part = flat  # live positions i..W-1-i
    for i in range(length // 2):
        t = part.shape[-1]
        mid = t // 16
        b = part.reshape(part.shape[:-1] + (4, mid, 4))
        m2 = b
        for q in range(length - 2 - i, i, -1):
            mm = m2.shape[-2]
            x = m2.reshape(m2.shape[:-3] + (4, 4, mm // 4, 4))
            m2 = torch.einsum("...amqb,...m->...aqb", x, masks[..., q, :])
        # m2: [..., 4 (top = W-1-i), 1, 4 (bottom = i)]
        pm = m2.reshape(m2.shape[:-3] + (4, 4))
        out.append(pm.transpose(-1, -2))  # -> (digit_i, digit_{W-1-i})
        v = torch.einsum("...mqb,...m->...qb", b,
                         masks[..., length - 1 - i, :])
        part = torch.einsum("...qb,...b->...q", v, masks[..., i, :])
    return torch.stack(out, dim=-3)


# ---------------------------------------------------------------------------
# id arithmetic
# ---------------------------------------------------------------------------


def rc_ids(length: int, device) -> torch.Tensor:
    """[4**W] int64 reverse-complement ids."""
    return encoding.rc_ids_flat(length, device)


def canonical_mask(length: int, device) -> torch.Tensor:
    return encoding.canonical_mask_flat(length, device)


def rc_gather(flat: torch.Tensor, length: int) -> torch.Tensor:
    """flat'[id] = flat[revcomp(id)] via one gather."""
    return flat[..., rc_ids(length, flat.device)]


# ---------------------------------------------------------------------------
# background probabilities
# ---------------------------------------------------------------------------


def _rev4_perm(k_eff: int) -> np.ndarray:
    """Permutation mapping a little-endian (k_eff+1)-digit sub-id to the
    BaMM big-endian kmer id (reference layouts: src/base_pattern.h:20-29
    vs 88-107)."""
    n = k_eff + 1
    sub = np.arange(4 ** n, dtype=np.int64)
    out = np.zeros(4 ** n, dtype=np.int64)
    for j in range(n):
        out += ((sub >> (2 * j)) & 3) << (2 * (n - 1 - j))
    return out


def bg_prob_flat(v: Sequence[torch.Tensor], length: int,
                 order: int) -> torch.Tensor:
    """Flat [4**W] f32 background probabilities for one Markov order,
    multiplied in the reference's left-to-right position order
    (reference: src/base_pattern.cpp:285-325); bit-equal to the host fold.

    v[j]: [4**(j+1)] f32 conditional table in BaMM big-endian layout, on
    the device the table is built on.
    """
    dev = v[0].device
    p = torch.ones(4 ** length, dtype=F32, device=dev)
    for pos in range(length):
        k_eff = min(pos, order)
        # factor for position pos depends on the contiguous digit block
        # pos-k_eff..pos: broadcast the permuted conditional over
        # (hi, 4**(k_eff+1), lo)
        perm = upload(_rev4_perm(k_eff), dev)
        vk = v[k_eff].to(F32)[perm]
        lo = 4 ** (pos - k_eff)
        blk = 4 ** (k_eff + 1)
        hi = 4 ** length // (blk * lo)
        p = (p.reshape(hi, blk, lo) * vk.reshape(1, blk, 1)).reshape(-1)
    return p


def aggregate_double_strand_flat(p: torch.Tensor,
                                 length: int) -> torch.Tensor:
    """p'[id] = p[id] + p[rc(id)], palindromes untouched
    (reference: src/base_pattern.cpp:268-283)."""
    rc = rc_ids(length, p.device)
    ids = torch.arange(4 ** length, device=p.device)
    return torch.where(ids == rc, p, p + p[rc])


# ---------------------------------------------------------------------------
# optimization scores
#
# The reference stores scores in ``float`` variables but C-library
# transcendentals promote to double.  These replicate each rounding
# point: f32 elementwise steps, f64 log/exp/sqrt, rounded back to f32
# exactly where the C++ expression assigns to a float.  A Python scalar
# next to a tensor takes the tensor's dtype (as a weakly typed scalar
# does in JAX); a scalar divided BY a tensor is written with a tensor
# numerator, since torch's ``scalar / tensor`` multiplies by a
# reciprocal and rounds twice.
# ---------------------------------------------------------------------------


def _f32(x):
    return torch.as_tensor(x).to(F32)


def _f64(x):
    return torch.as_tensor(x).to(F64)


def _scalar_f32(x, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim f32 tensor on ``like``'s device (n_sequences, pseudo)."""
    return upload(x, like.device, F32)


def _entropy_f(p32):
    """F32(-p*log(p) - (1-p)*log(1-p)), double internally
    (reference: src/utils.h:25-27)."""
    pd = _f64(p32)
    return _f32(-pd * torch.log(pd) - (1.0 - pd) * torch.log(1.0 - pd))


def mutual_information_score(obs, exp_, n_sequences) -> torch.Tensor:
    """-sum_q MI/H(q) over priors {0.5, 0.1, 0.01}; 0 when obs < exp
    (reference: src/base_pattern.cpp:184-200, src/utils.h:29-37)."""
    obs = _f32(obs)
    exp_ = _f32(exp_)
    n = _scalar_f32(n_sequences, obs)
    # p = F32(1.0(double) - exp(double(F32(-(obs/n)))))
    p_obs = _f32(1.0 - torch.exp(_f64(_f32(-(obs / n)))))
    p_exp = _f32(1.0 - torch.exp(_f64(_f32(-(exp_ / n)))))
    score = torch.zeros(obs.shape, dtype=F32, device=obs.device)
    for q in (0.5, 0.1, 0.01):
        qf = np.float32(q)
        one_m_q = np.float32(np.float32(1.0) - qf)
        p = _f32(_f32(p_obs * float(qf)) + _f32(p_exp * float(one_m_q)))
        mi = _f32(_f32(_entropy_f(p_obs) * float(-qf))
                  - _f32(_entropy_f(p_exp) * float(one_m_q))
                  + _entropy_f(p))
        # H(q): double math on the host, f32 result
        hq = np.float32(-float(qf) * math.log(float(qf))
                        - (1.0 - float(qf)) * math.log(1.0 - float(qf)))
        score = _f32(score + _f32(mi / float(hq)))
    return torch.where(obs < exp_, torch.zeros((), dtype=F32,
                                               device=obs.device),
                       _f32(-score))


def enrichment_score(obs, exp_, pseudo_expected) -> torch.Tensor:
    """F32((expected + pseudo) / observed)
    (reference: src/base_pattern.cpp:180-182)."""
    exp_ = _f32(exp_)
    return _f32(_f32(exp_ + _scalar_f32(pseudo_expected, exp_))
                / _f32(obs))


def iupac_zscore(obs, exp_) -> torch.Tensor:
    """F32(double(F32(n - mu)) / sqrt(double(mu)))
    (reference: src/iupac_pattern.cpp:446)."""
    num = _f32(_f32(obs) - _f32(exp_))
    return _f32(_f64(num) / torch.sqrt(_f64(_f32(exp_))))


def iupac_log_pvalue(obs, exp_, zscore, bonferroni_sum) -> torch.Tensor:
    """IUPAC log p-value with the per-letter Bonferroni penalty sum
    added by the caller (reference: src/iupac_pattern.cpp:453-469; note
    the all-f32 ``frac``)."""
    obs = torch.as_tensor(obs)
    mu = _f32(exp_)
    n = _f32(obs)
    frac = _f32(1.0 - _f32(mu / _f32(n + 1)))
    nd = _f64(n)
    ratio = _f32(mu / n)
    body = (nd * torch.log(_f64(ratio)) + nd - _f64(mu)
            - 0.5 * torch.log(6.283 * nd * _f64(frac) * _f64(frac)))
    cond = (n > mu) & (obs > 5) & (zscore > 2)
    zero = torch.zeros((), dtype=F32, device=n.device)
    logp = torch.where(cond, _f32(body), zero)
    logp = torch.where(obs == 0, torch.full((), math.inf, dtype=F32,
                                             device=n.device), logp)
    return _f32(logp + _f32(bonferroni_sum))


def base_log_pvalues_ref(counts, expected) -> torch.Tensor:
    """Base-pattern log p-values with the reference's promotion points
    (reference: src/base_pattern.cpp:231-250; the literal 1.0 makes
    ``frac`` a double subtraction)."""
    counts = torch.as_tensor(counts)
    n32 = _f32(counts)
    mu = _f32(expected)
    frac = _f32(1.0 - _f64(_f32(mu / _f32(n32 + 1))))
    nd = _f64(n32)
    ratio = _f32(mu / n32)
    body = (nd * torch.log(_f64(ratio)) + nd - _f64(mu)
            - 0.5 * torch.log(6.283 * nd * _f64(frac) * _f64(frac)))
    zero = torch.zeros((), dtype=F32, device=n32.device)
    out = torch.where((n32 > mu) & (counts > 5), _f32(body), zero)
    return torch.where(counts == 0, torch.full((), math.inf, dtype=F32,
                                                device=n32.device), out)


def optimization_scores(score_type: int, obs, exp_, n_sequences,
                        pseudo_expected, bonferroni_sum) -> torch.Tensor:
    """Vectorized minimized score (reference: src/iupac_pattern.cpp:648-689).
    score_type: 0 = LOGPVAL, 1 = ENRICHMENT, 2 = MUTUAL_INFO."""
    if score_type == 1:
        return enrichment_score(obs, exp_, pseudo_expected)
    if score_type == 2:
        return mutual_information_score(obs, exp_, n_sequences)
    z = iupac_zscore(obs, exp_)
    return iupac_log_pvalue(obs, exp_, z, bonferroni_sum)


def base_optimization_scores(score_type: int, obs, exp_, logp, n_sequences,
                             pseudo_expected) -> torch.Tensor:
    """Seed (base-pattern) scores: LOGPVAL reads the base table
    (reference: src/base_pattern.cpp:202-224)."""
    if score_type == 0:
        return logp
    if score_type == 1:
        return enrichment_score(obs, exp_, pseudo_expected)
    return mutual_information_score(obs, exp_, n_sequences)
