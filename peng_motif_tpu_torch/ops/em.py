"""Saturated EM over the full 4**W count table, batched over motifs.

Counterpart of ``peng_motif_tpu/ops/em.py``: ``em_optimize_flat`` (the
device engine's EM) and the rank-W ``em_optimize``.  The
reference's EM (src/peng.cpp:48-197) recomputes, per iteration and per
motif, odds[id] = prod_p pwm[p][c_p] / bg[id] over all 4**W ids, then
accumulates responsibilities r[id] = count[id] * s / (1 + s / odds[id])
into a new PWM.

:func:`em_optimize_flat` runs a round on a CUDA device as one
hand-written kernel pass over the ids and a small tail launch
(``csrc/em.cu``: :func:`em_optimize_flat_kernel`), and anywhere else as
the plain PyTorch version, :func:`em_optimize_flat_plain`: W broadcast
multiplies over the flat table and the all-ones-mask marginal of the
responsibility table (ops/flat_tables), for every still-active motif at
once.  Both compute every responsibility bit for bit alike; the
marginals' sums run in another (fixed) order on the card.

Iteration control mirrors the reference exactly: a motif iterates while
(change > min_threshold) and (iterations < max_iterations), where change
is the L1 difference of the normalized new PWM vs the previous one
(src/peng.cpp:104-144); a motif that stops is frozen (PWM and iteration
count) while the others go on.
"""

from __future__ import annotations

import numpy as np
import torch

from . import encoding
from . import flat_tables as ft
from .histogram import build_kernels, on_device
from ..utils.logging_utils import count, span, sync_read, upload

F32 = torch.float32

# kernel launches made by :func:`em_optimize_flat_kernel` (two a round,
# nowhere else): a run reads it to show EM went through the kernel
LAUNCHES = 0
# the widest table the kernel takes (csrc/em.cu kMaxW), the ids of a
# block's tile (4**6) and its partials a motif
_MAX_W = 16
_TILE_DIGITS = 6
_PART = 25


def em_optimize_flat(pwms: torch.Tensor, counts_flat: torch.Tensor,
                     bg_flat: torch.Tensor, saturation_factor,
                     min_threshold, max_iterations: int, length: int):
    """pwms: [M, W, 4] f32; counts_flat / bg_flat: [4**W] (mirrored
    counts; strand-aggregated bg of the optimization order), all on one
    device.  Returns (final pwms [M, W, 4] f32, iterations [M] int32).
    The kernel's rounds count in ``em.kernel_rounds`` (0 off CUDA)."""
    count("em.kernel_rounds", 0)
    fn = (em_optimize_flat_kernel if pwms.device.type == "cuda"
          else em_optimize_flat_plain)
    return fn(pwms, counts_flat, bg_flat, saturation_factor, min_threshold,
              max_iterations, length)


def _kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` as contiguous f32 whose start is 16-byte aligned (the
    kernel reads it as float4)."""
    t = t.to(F32).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def em_optimize_flat_kernel(pwms: torch.Tensor, counts_flat: torch.Tensor,
                            bg_flat: torch.Tensor, saturation_factor,
                            min_threshold, max_iterations: int,
                            length: int):
    """:func:`em_optimize_flat` on a CUDA device: two kernel launches and
    one host read (the round's "any motif still active" flag) a round,
    inside the span ``em_round``.  The motifs' state (PWMs, change,
    iterations, active flags) stays on the card in fixed shapes; the
    kernel skips a frozen motif by its flag.  Raises on what the kernel
    does not take and on a refused launch."""
    global LAUNCHES
    dev = pwms.device
    if dev.type != "cuda":
        raise ValueError(f"em kernel: needs a CUDA device, got {dev}")
    if not 1 <= length <= _MAX_W:
        raise ValueError(
            f"em kernel: W must lie in [1, {_MAX_W}], got {length}")
    n = 4 ** length
    M = pwms.shape[0]
    if tuple(pwms.shape[1:]) != (length, 4):
        raise ValueError(f"em kernel: pwms must be [M, {length}, 4], got "
                         f"{tuple(pwms.shape)}")
    for name, t in (("counts", counts_flat), ("bg", bg_flat)):
        if t.device != dev or tuple(t.shape) != (n,):
            raise ValueError(
                f"em kernel: {name} must be [{n}] on {dev}, got "
                f"{tuple(t.shape)} on {t.device}")
    pwm = pwms.to(F32).clone(memory_format=torch.contiguous_format)
    iters = torch.zeros(M, dtype=torch.int32, device=dev)
    # every motif starts alike: change = W, no iteration (as the plain
    # version's first test of its active mask, in f32)
    s, thr = np.float32(saturation_factor), np.float32(min_threshold)
    go = M > 0 and bool(np.float32(length) > thr) and max_iterations > 0
    if not go:
        return pwm, iters
    change = torch.full((M,), float(length), dtype=F32, device=dev)
    active = torch.ones(M, dtype=torch.uint8, device=dev)
    counts = _kernel_operand(counts_flat)
    bg = _kernel_operand(bg_flat)
    tiles = 4 ** max(0, length - _TILE_DIGITS)
    part = torch.empty(M * tiles * _PART, dtype=F32, device=dev)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    max_it = min(int(max_iterations), 2 ** 31 - 1)
    lib = build_kernels()
    with on_device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        while go:
            with span("em_round"):
                err = lib.peng_em_round(
                    counts.data_ptr(), bg.data_ptr(), pwm.data_ptr(),
                    change.data_ptr(), iters.data_ptr(), active.data_ptr(),
                    flag.data_ptr(), part.data_ptr(), M, length, float(s),
                    float(thr), max_it, stream)
                if err != 0:
                    raise RuntimeError(
                        f"em kernel launch failed: CUDA error {err} (W "
                        f"{length}, {M} motifs)")
                LAUNCHES += 2
                count("em.kernel_rounds")
                go = sync_read(flag, bool)
    return pwm, iters


def em_optimize_flat_plain(pwms: torch.Tensor, counts_flat: torch.Tensor,
                           bg_flat: torch.Tensor, saturation_factor,
                           min_threshold, max_iterations: int, length: int):
    """The plain PyTorch version of :func:`em_optimize_flat`, on any
    device (the tests' and ``chip_smoke.py``'s yardstick on the card)."""
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
    frozen, as in :func:`em_optimize_flat_plain`.  Unlike the flat form, the
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
