"""Batched IUPAC-pattern aggregation as separable mask contractions, on
the rank-W tensor.

Counterpart of ``peng_motif_tpu/ops/iupac_sum.py``.  The reference
binary expands every IUPAC pattern into its matching base k-mers with a
stack walk, sorts them, and sums table entries over distinct canonical
ids (src/iupac_pattern.cpp:331-473, 806-833).  The same quantity is a
dense contraction: an IUPAC pattern is a per-position 0/1 mask m_p over
ACGT, its match indicator over all 4**W ids factorizes as
M[id] = prod_p m_p[c_p], and so does the reverse-complement indicator,
Mrc[id] = prod_p m'_p[c_p] with m'_p[c] = m_{W-1-p}[3-c] (the mask
matrix flipped along both axes).  "Sum of x over *distinct* canonical
matching ids" is then

    sum_id  x[id] * canon[id] * (M or Mrc)[id]
  = S(m) + S(m') - S(m & m')          with S separable per axis,

three chained axis contractions of the canonical-masked table, kept in
that order.  Single-strand aggregation is the single term S(m) over the
raw table.

Counts are contracted in their integer type: a broadcast multiply and a
``sum`` over the axis, never through floats (CUDA has no int32 matmul;
int32 sums accumulate in int64 and are cast back, exact while the
reference's int32 result is).  Float tables are contracted in f32 with
TF32 off (device.resolve_device).  Where the reference ``vmap``s over
masks, the masks carry a leading batch dimension here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..alphabets import IUPAC_MASKS, iupac_id_to_digits


def masks_from_iupac_digits(digits) -> np.ndarray:
    """[W, 4] int32 0/1 mask matrix for an IUPAC digit vector."""
    return IUPAC_MASKS[np.asarray(digits, dtype=np.int64)]


def masks_from_iupac_id(pattern_id: int, length: int) -> np.ndarray:
    return masks_from_iupac_digits(iupac_id_to_digits(pattern_id, length))


def _contract_leading(res: torch.Tensor, mask: torch.Tensor,
                      axis: int) -> torch.Tensor:
    """sum_c mask[..., c] * res[..., c, ...] over ``axis`` of ``res``;
    ``mask``: [B, 4], ``res``: [B, ...] with the batch leading."""
    shape = [mask.shape[0]] + [1] * (res.ndim - 1)
    shape[axis] = 4
    prod = res * mask.reshape(shape).to(res.dtype)
    if res.dtype.is_floating_point:
        return prod.sum(dim=axis)
    return prod.sum(dim=axis, dtype=torch.int64).to(res.dtype)


def _sep_sum(table: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Full contraction of a rank-W table with one mask vector per axis,
    for a batch of mask sets.

    table: (4,)*W; masks: [B, W, 4] with masks[:, p] applying to pattern
    position p (tensor axis W-1-p).  Returns [B], in the table's dtype.
    """
    length = table.ndim
    res = table.unsqueeze(0).expand((masks.shape[0],) + table.shape)
    for pos in range(length - 1, -1, -1):
        # after the batch axis, the leading axis of res is position
        # ``pos``: contract positions from high to low
        res = _contract_leading(res, masks[:, pos], 1)
    return res


def _float_sums(tables: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Contract [F] + (4,)*W float tables with a batch of mask sets
    [B, W, 4] -> [B, F]."""
    length = tables.ndim - 1
    res = tables.unsqueeze(0).expand((masks.shape[0],) + tables.shape)
    for pos in range(length - 1, -1, -1):
        res = _contract_leading(res, masks[:, pos], 2)
    return res


def aggregate_batch(counts_t: torch.Tensor, float_tables: torch.Tensor,
                    masks: torch.Tensor, both_strands: bool = True):
    """Aggregate count + float tables over a batch of IUPAC masks.

    Args:
      counts_t: rank-W int32 count tensor.  In both_strands mode this must
        already be masked to canonical ids (counts * canon).
      float_tables: [F] + (4,)*W float32 stack (e.g. expected counts and
        background probabilities), canonical-masked in both_strands mode.
      masks: [B, W, 4] int32 0/1 candidate masks, on the tables' device.
      both_strands: distinct-canonical dedup vs plain sum.

    Returns:
      counts_sum [B] int32, float_sums [B, F] float32.
    """
    m = masks
    if not both_strands:
        return _sep_sum(counts_t, m), _float_sums(float_tables,
                                                  m.to(torch.float32))
    mrc = torch.flip(m, (-2, -1))
    mand = m * mrc
    c = (_sep_sum(counts_t, m) + _sep_sum(counts_t, mrc)
         - _sep_sum(counts_t, mand))
    mf, mrcf, mandf = (x.to(torch.float32) for x in (m, mrc, mand))
    f = (_float_sums(float_tables, mf) + _float_sums(float_tables, mrcf)
         - _float_sums(float_tables, mandf))
    return c, f
