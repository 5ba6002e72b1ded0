"""Elementwise per-pattern statistics over the 4**W table.

Counterpart of ``peng_motif_tpu/ops/stats.py`` (reference binary:
src/base_pattern.cpp:231-265: expected counts, log p-values, z-scores).
Plain f32 tensor functions on the inputs' device, any shape.

These are the all-f32 formulas of the reference package's tensor path.
``flat_tables.base_log_pvalues_ref`` computes the same log p-value with
the reference *binary's* promotion points (f64 ``log``, the double
subtraction in ``frac``, f32 only where the C++ assigns to a float) and
is what the exact engine's byte parity rests on; :func:`log_pvalues`
stays within f32 throughout and differs from it in the last digits, so
the two are not merged.
"""

from __future__ import annotations

import math

import torch

from ..utils.logging_utils import upload

F32 = torch.float32


def expected_counts(bg_prob: torch.Tensor, ltot) -> torch.Tensor:
    """expected[id] = bg_prob[id] * ltot (reference:
    src/base_pattern.cpp:260-265; the reference converts the size_t
    window count to float too).  ``ltot``: a number or a 0-d tensor on
    the table's device (no host sync)."""
    return bg_prob * upload(ltot, bg_prob.device).to(F32)


def zscores(counts: torch.Tensor, expected: torch.Tensor) -> torch.Tensor:
    """z = (observed - expected) / sqrt(expected)
    (reference: src/base_pattern.cpp:252-258)."""
    return (counts.to(F32) - expected) / torch.sqrt(expected)


def log_pvalues(counts: torch.Tensor, expected: torch.Tensor) -> torch.Tensor:
    """Stirling-approximated upper-tail log p-value per pattern
    (reference: src/base_pattern.cpp:231-250).

    counts == 0            -> +inf
    counts <= mu or <= 5   -> 0
    else n*log(mu/n) + n - mu - 0.5*log(6.283*n*frac^2), frac = 1 - mu/(n+1)

    The body is NaN at n == 0 (0 * log(inf)); it is computed everywhere
    and masked by ``where``, as the reference does.  f32 ``log`` may
    differ from another library's by an ulp: within 2e-6 relative of the
    reference package, the ``inf`` and 0 positions identical.
    """
    n = counts.to(F32)
    mu = expected
    frac = 1.0 - mu / (n + 1.0)
    # 6.283 rounded to f32 once, as the reference's f32 literal is
    two_pi = upload(6.283, n.device, F32)
    body = n * torch.log(mu / n) + n - mu - 0.5 * torch.log(
        two_pi * n * frac * frac)
    zero = torch.zeros((), dtype=F32, device=n.device)
    out = torch.where((n > mu) & (n > 5), body, zero)
    return torch.where(counts == 0,
                       torch.full((), math.inf, dtype=F32, device=n.device),
                       out)
