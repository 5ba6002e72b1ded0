"""Pattern-id conventions and per-window ids on torch tensors.

The flat index of a ``4**W`` pattern table is the PEnG little-endian
pattern id (reference: src/base_pattern.h:20-29):

    flat id = sum_p c_p * 4**p      (position p has factor 4**p)

The reverse-complement, canonical-mask and canonical-index tables are
built once per width in numpy (``_np_*``, cached) and copied to the
requested device; the device code only gathers with them.

The rank-W view of the same table has shape ``(4,) * W`` with
``T[c_{W-1}, ..., c_1, c_0] = flat[id]``, so **tensor axis a carries
pattern position W-1-a** (:func:`axis_of_pos`).  There the
reverse-complement permutation is layout only: reversing the positions
is an axis transpose, complementing each letter (c -> 3-c) an axis flip
(:func:`rc_permute`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.logging_utils import upload


@functools.lru_cache(maxsize=None)
def _np_rc_ids(length: int) -> np.ndarray:
    ids = np.arange(4 ** length, dtype=np.int64)
    rc = np.zeros_like(ids)
    for p in range(length):
        digit = (ids >> (2 * p)) & 3
        rc |= (3 - digit) << (2 * (length - 1 - p))
    return rc.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _np_canonical_mask(length: int) -> np.ndarray:
    ids = np.arange(4 ** length, dtype=np.int64)
    return ids <= _np_rc_ids(length)


@functools.lru_cache(maxsize=None)
def _np_canonical_idx(length: int) -> np.ndarray:
    return np.flatnonzero(_np_canonical_mask(length)).astype(np.int32)


def rc_ids_flat(length: int, device) -> torch.Tensor:
    """Flat [4**W] int64 tensor of reverse-complement ids (gather index)."""
    return upload(_np_rc_ids(length), device, torch.int64)


def canonical_mask_flat(length: int, device) -> torch.Tensor:
    """Flat [4**W] bool mask: id <= revcomp(id)."""
    return upload(_np_canonical_mask(length), device)


def canonical_idx_flat(length: int, device) -> torch.Tensor:
    """Ascending ids with id <= revcomp(id), [(4**W + pal)/2] int64."""
    return upload(_np_canonical_idx(length), device, torch.int64)


# ---------------------------------------------------------------------------
# the rank-W view (counterpart of peng_motif_tpu/ops/encoding.py:31-65,
# 112-157)
# ---------------------------------------------------------------------------


def axis_of_pos(length: int, pos: int) -> int:
    """Tensor axis carrying pattern position ``pos``."""
    return length - 1 - pos


def to_tensor(flat: torch.Tensor, length: int) -> torch.Tensor:
    """Reshape a flat [4**W] table to the rank-W tensor."""
    return flat.reshape((4,) * length)


def to_flat(tensor: torch.Tensor) -> torch.Tensor:
    return tensor.reshape(-1)


def rc_permute(tensor: torch.Tensor) -> torch.Tensor:
    """Given T[id] (rank-W), return T'[id] = T[revcomp(id)]: every axis
    flipped (c -> 3-c), then the axes reversed (position order).  torch
    has no negative strides, so the flip copies; the result equals a
    gather by :func:`rc_ids_flat` bit for bit."""
    ndim = tensor.ndim
    flipped = torch.flip(tensor, tuple(range(ndim)))
    return flipped.permute(tuple(reversed(range(ndim))))


def pattern_ids_tensor(length: int, device) -> torch.Tensor:
    """Rank-W tensor whose entry at index id is id itself (int32)."""
    return to_tensor(torch.arange(4 ** length, dtype=torch.int32,
                                  device=device), length)


def rc_ids_tensor(length: int, device) -> torch.Tensor:
    """Rank-W tensor of reverse-complement ids (int32)."""
    return rc_permute(pattern_ids_tensor(length, device))


def canonical_mask(length: int, device) -> torch.Tensor:
    """Boolean rank-W tensor: id <= revcomp(id), the canonical
    representatives of the double-strand dedup (reference:
    src/base_pattern.cpp:362-364 uses min(id, revcomp))."""
    ids = pattern_ids_tensor(length, device)
    return ids <= rc_permute(ids)


def np_rc_permute(table: np.ndarray, length: int) -> np.ndarray:
    """Numpy mirror of :func:`rc_permute` on a flat table."""
    t = table.reshape((4,) * length)
    t = t[(slice(None, None, -1),) * length]
    return np.transpose(t, tuple(reversed(range(length)))).reshape(-1)


def window_ids(codes: torch.Tensor, length: int):
    """Per-window pattern ids for a batch of encoded sequences.

    Args:
      codes: [B, L] uint8/int32 BaMM codes (0 = N/undefined/padding).
      length: pattern length W.

    Returns:
      (fwd_ids, rc_ids, valid): each [B, L - W + 1]; ids are int32 PEnG
      little-endian pattern ids; ``valid`` marks windows made entirely of
      defined bases (the reference skips windows containing code 0,
      src/base_pattern.cpp:350-353).  Invalid windows read id 0.
    """
    codes = codes.to(torch.int32)
    n_win = codes.shape[-1] - length + 1
    shape = codes.shape[:-1] + (n_win,)
    fwd = torch.zeros(shape, dtype=torch.int32, device=codes.device)
    rc = torch.zeros_like(fwd)
    valid = torch.ones(shape, dtype=torch.bool, device=codes.device)
    for p in range(length):
        c = codes[..., p : p + n_win]
        valid &= c > 0
        fwd += (c - 1) * (4 ** p)
        rc += (4 - c) * (4 ** (length - 1 - p))
    fwd = torch.where(valid, fwd, 0)
    rc = torch.where(valid, rc, 0)
    return fwd, rc, valid
