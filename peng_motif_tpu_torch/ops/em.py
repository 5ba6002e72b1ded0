"""Saturated EM over the full 4**W count table, batched over motifs.

Counterpart of ``peng_motif_tpu/ops/em.py``: ``em_optimize_flat`` (the
device engine's EM) and the rank-W ``em_optimize``.  The
reference's EM (src/peng.cpp:48-197) recomputes, per iteration and per
motif, odds[id] = prod_p pwm[p][c_p] / bg[id] over all 4**W ids, then
accumulates responsibilities r[id] = count[id] * s / (1 + s / odds[id])
into a new PWM.  Here the product is W broadcast multiplies over the
flat table and the PWM update is the all-ones-mask marginal of the
responsibility table (ops/flat_tables), for every still-active motif at
once.

Iteration control mirrors the reference exactly: a motif iterates while
(change > min_threshold) and (iterations < max_iterations), where change
is the L1 difference of the normalized new PWM vs the previous one
(src/peng.cpp:104-144); a motif that stops is frozen (PWM and iteration
count) while the others go on.
"""

from __future__ import annotations

import torch

from . import encoding
from . import flat_tables as ft
from ..utils.logging_utils import span, sync_read, upload

F32 = torch.float32


def em_optimize_flat(pwms: torch.Tensor, counts_flat: torch.Tensor,
                     bg_flat: torch.Tensor, saturation_factor,
                     min_threshold, max_iterations: int, length: int):
    """pwms: [M, W, 4] f32; counts_flat / bg_flat: [4**W] (mirrored
    counts; strand-aggregated bg of the optimization order), all on one
    device.  Returns (final pwms [M, W, 4] f32, iterations [M] int32)."""
    dev = pwms.device
    s = upload(float(saturation_factor), dev, F32)
    thr = upload(float(min_threshold), dev, F32)
    counts_s = counts_flat.to(F32) * s
    bg = bg_flat.to(F32)
    ones = torch.ones((length, 4), dtype=F32, device=dev)
    n = 4 ** length
    M = pwms.shape[0]

    pwm = pwms.to(F32).clone()
    iters = torch.zeros(M, dtype=torch.int32, device=dev)
    change = torch.full((M,), float(length), dtype=F32, device=dev)
    active = (change > thr) & (iters < max_iterations)
    # one span a round, ending in the round's host sync: is any motif
    # still active?
    go = sync_read(active.any(), bool)
    while go:
        with span("em_round"):
            idx = sync_read(active, torch.nonzero)[:, 0]
            old = pwm[idx]                                   # [A, W, 4]
            A = old.shape[0]
            # prob[id] = prod_p pwm[p][digit_p]: the same left-to-right
            # f32 multiply chain as the reference's recursive descent
            # (src/peng.cpp:180-197) — bit-equal per entry
            prob = torch.ones((A, n), dtype=F32, device=dev)
            for pos in range(length):
                lo = 4 ** pos
                prob = (prob.reshape(A, n // (4 * lo), 4, lo)
                        * old[:, pos].reshape(A, 1, 4, 1)).reshape(A, n)
            # the reference's exact op order (src/peng.cpp:118-127):
            # odds = prob/bg, then count*s / (1 + s/odds)
            odds = prob / bg
            del prob
            r = counts_s / (s / odds + 1.0)
            del odds
            new = ft.all_marginals(r, ones, length)          # [A, W, 4]
            del r
            # normalize_pwm sums each row sequentially
            # (src/iupac_pattern.cpp:291-303)
            rs = ((new[..., 0] + new[..., 1]) + new[..., 2]) + new[..., 3]
            new = new / rs[..., None]
            # change: sequential f32 fold in (p, a) order
            # (src/peng.cpp:131-137)
            d = (new - old).abs().reshape(A, -1)
            ch = torch.zeros(A, dtype=F32, device=dev)
            for i in range(4 * length):
                ch = ch + d[:, i]
            pwm[idx] = new
            change[idx] = ch
            iters[idx] += 1
            active = (change > thr) & (iters < max_iterations)
            go = sync_read(active.any(), bool)
    return pwm, iters


# ---------------------------------------------------------------------------
# the rank-W form
# ---------------------------------------------------------------------------


def _pwm_product(pwm: torch.Tensor, length: int) -> torch.Tensor:
    """prod_p pwm[..., p, c_p] as a rank-W tensor ([...] + (4,)*W)."""
    lead = pwm.shape[:-2]
    res = torch.ones(lead + (4,) * length, dtype=F32, device=pwm.device)
    for pos in range(length):
        axis = encoding.axis_of_pos(length, pos)
        shape = lead + (1,) * axis + (4,) + (1,) * (length - axis - 1)
        res = res * pwm[..., pos, :].reshape(shape)
    return res


def _axis_sums(r: torch.Tensor, length: int) -> torch.Tensor:
    """[..., W, 4]: row p = sum of r over all of its last W axes except
    axis_of_pos(p)."""
    lead = r.ndim - length
    rows = []
    for pos in range(length):
        axis = encoding.axis_of_pos(length, pos)
        axes = tuple(lead + a for a in range(length) if a != axis)
        rows.append(r.sum(dim=axes))
    return torch.stack(rows, dim=-2)


def em_optimize(pwms: torch.Tensor, counts_t: torch.Tensor,
                bg_t: torch.Tensor, saturation_factor: float,
                min_threshold: float, max_iterations: int, length: int):
    """Saturated EM on a batch of PWMs over rank-W tables (reference
    package: ops/em.py::em_optimize; binary: src/peng.cpp:48-144).

    pwms: [M, W, 4] f32; counts_t: rank-W f32 (mirrored counts, both
    ids); bg_t: rank-W f32 (strand-aggregated), all on one device.
    Returns (final pwms [M, W, 4] f32, iterations [M] int32).

    The reference runs one ``while_loop`` per motif under ``vmap``; here
    the still-active motifs iterate together and a motif that stops is
    frozen, as in :func:`em_optimize_flat`.  Unlike the flat form, the
    row sums, the normalization and the change are plain ``sum``s, whose
    order neither library fixes: against the reference package the
    iteration counts are identical on the tests' inputs and the PWM
    cells agree within 1e-6 absolute.
    """
    dev = pwms.device
    s = upload(float(saturation_factor), dev, F32)
    thr = upload(float(min_threshold), dev, F32)
    counts_s = counts_t.to(F32) * s  # iteration-invariant
    bg = bg_t.to(F32)
    M = pwms.shape[0]

    pwm = pwms.to(F32).clone()
    iters = torch.zeros(M, dtype=torch.int32, device=dev)
    change = torch.full((M,), float(length), dtype=F32, device=dev)
    active = (change > thr) & (iters < max_iterations)
    while sync_read(active.any(), bool):
        idx = sync_read(active, torch.nonzero)[:, 0]
        old = pwm[idx]                                   # [A, W, 4]
        odds = _pwm_product(old, length) / bg
        r = counts_s / (s / odds + 1.0)
        del odds
        new = _axis_sums(r, length)                      # [A, W, 4]
        del r
        new = new / new.sum(dim=-1, keepdim=True)
        pwm[idx] = new
        change[idx] = (new - old).abs().sum(dim=(-2, -1))
        iters[idx] += 1
        active = (change > thr) & (iters < max_iterations)
    return pwm, iters
