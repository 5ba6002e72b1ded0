"""The seed z-sort of the device engine, with its large partitions on the
device.

The seed walk reads the 4**W patterns in the order libstdc++'s
``std::sort`` gives them by descending z-score, up to the first one below
the threshold (reference: src/base_pattern.cpp:443-515).  Every k-mer
ties with its reverse complement on both strands, so that order is
std::sort's tie placement, and only the same algorithm gives it.
pengnative.cpp's ``zscore_sort_prefix`` runs it on the host over the
whole table, pruning the recursion into ranges that lie beyond the
walk's prefix.  Here the same pruned introsort loop runs where z is:

  * each of libstdc++'s partitions (``__unguarded_partition_pivot``) is
    deterministic.  It moves the median of ``first + 1``, ``mid`` and
    ``last - 1`` to ``first`` (``__move_median_to_first``), then swaps
    A_k, the k-th position from the left with z <= p, with B_k, the k-th
    position from the right with z >= p (the pivot's slot counts), for k
    = 1 .. m, m the largest k with A_k < B_k, and returns cut =
    min(A_{m+1}, B_m) (A_1 where m = 0).  :func:`_partition` computes
    that with flags, two prefix counts and one gather, on the device;
  * ranges are independent once partitioned, so the order in which they
    are worked does not matter, only each range's depth budget
    (2 lg n at the start, one less per partition above it);
  * a range of at most :data:`HOST_RANGE` pairs, or one whose budget is
    spent, is left to the host: ``seed_sort_finish`` (csrc/seedsort.cpp)
    runs the pruned loop on it with its budget and then the final
    insertion pass, on the pairs [0, R) fetched once.

So the prefix comes out element for element as ``zscore_sort_prefix``'s.
Tables with a NaN z-score (whose std::sort order is control-flow
defined), tables where nearly every entry is kept, and tables of at most
HOST_RANGE entries are sorted whole on the host (:func:`device_keep`
says which).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..native import seed_sort_finish_native
from ..utils.logging_utils import count, sync_read

# Ranges of at most this many pairs are partitioned on the host.  Fitted
# on "NVIDIA H100 80GB HBM3, 700.00 W" with 8 host cores (PERF.md §6):
# below 4M pairs a partition on the card costs 1.1-1.9 ms, mostly
# launches, and the host's fetch and finish of a range grow by 1.1-1.6 ms
# a doubling between 2**16 and 2**18 pairs; MafK's whole sort at W = 12
# took 24.5 ms at 2**16, 21.4 at 2**17, 19.9 at 2**18, 19.7 at 2**19.
# At least libstdc++'s _S_threshold (16): shorter ranges are left to the
# final insertion pass.
HOST_RANGE = 1 << 17

_THRESHOLD = 16       # libstdc++'s _S_threshold


class SeedPrefix(NamedTuple):
    """The z-sorted prefix [0, keep] that the seed walk reads: pattern
    ids, their z-scores and expected counts (numpy)."""

    ids: np.ndarray        # uint32
    z: np.ndarray          # float32
    expected: np.ndarray   # float32


def device_keep(z: torch.Tensor, zthr: float) -> Optional[int]:
    """The number of patterns with z not below ``zthr``, where the device
    sorts the table's large ranges; None where the host sorts the whole
    table (at most HOST_RANGE entries, a NaN z-score, or fewer than 33
    entries left below the threshold, as zscore_sort_prefix decides)."""
    n = z.numel()
    if n <= HOST_RANGE:
        return None
    thr = float(np.float32(zthr))
    keep, nan = sync_read(torch.stack([
        (~(z < thr)).sum(), torch.isnan(z).any().to(torch.int64)])).tolist()
    if nan or keep + 32 >= n:
        return None
    return keep


def _partition(z: torch.Tensor, ids: torch.Tensor, first: int,
               last: int) -> int:
    """libstdc++'s ``__unguarded_partition_pivot`` on the pairs [first,
    last) of (z, ids), in place, with the comparator z[a] > z[b]; returns
    the cut (one read of the device)."""
    n = last - first
    seg_z, seg_i = z[first:last], ids[first:last]
    dev = z.device
    # __move_median_to_first(first, first + 1, mid, last - 1)
    mid = n // 2
    a, b, c = seg_z[1], seg_z[mid], seg_z[n - 1]
    ab, bc, ac = a > b, b > c, a > c
    take_b = (ab & bc) | ~(ab | ac | bc)
    take_c = (ab & ~bc & ac) | (~ab & ~ac & bc)
    pick = 1 + take_b.long() * (mid - 1) + take_c.long() * (n - 2)
    swap = torch.stack([pick * 0, pick])
    seg_z.index_copy_(0, swap.flip(0), seg_z.index_select(0, swap))
    seg_i.index_copy_(0, swap.flip(0), seg_i.index_select(0, swap))
    p = seg_z[:1].clone()
    # A: positions 1 .. n-1 with z <= p, ranked from the left (cl); B:
    # positions 0 .. n-1 with z >= p (0 is the pivot's), ranked from the
    # right (rr).  A_k < B_k while at least k of B lie right of A_k.
    le = seg_z[1:] <= p
    ge = seg_z >= p
    cl = le.cumsum(0, dtype=torch.int32)
    right = ge.sum(dtype=torch.int32) - ge.cumsum(0, dtype=torch.int32)
    swapped_a = le & (right[1:] >= cl)
    m = swapped_a.sum(dtype=torch.int32)
    rr = right + 1
    swapped_b = ge & (rr <= m)
    pos = torch.arange(n, device=dev)
    # a_at[k - 1] = A_k, b_at[k - 1] = B_k for k <= m; slot n takes the
    # rest
    a_at = torch.empty(n + 1, dtype=torch.int64, device=dev)
    a_at.scatter_(0, (cl - 1).masked_fill(~swapped_a, n).long(), pos[1:])
    b_at = torch.empty(n + 1, dtype=torch.int64, device=dev)
    b_at.scatter_(0, (rr - 1).masked_fill(~swapped_b, n).long(), pos)
    src = pos.clone()
    src[1:] = torch.where(
        swapped_a, b_at[(cl - 1).masked_fill(~swapped_a, n).long()],
        src[1:])
    src = torch.where(
        swapped_b, a_at[(rr - 1).masked_fill(~swapped_b, n).long()], src)
    seg_z.copy_(seg_z[src])
    seg_i.copy_(seg_i[src])
    # cut = min(A_{m+1}, B_m), A_1 where m = 0
    a_next = pos[1:].masked_fill(~(le & (cl == m + 1)), n).min()
    b_last = b_at.index_select(0, (m - 1).clamp(min=0).long().reshape(1)
                               ).masked_fill(m == 0, n)
    return first + sync_read(torch.minimum(a_next, b_last), int)


def device_partitions(z: torch.Tensor, ids: torch.Tensor, keep_end: int
                      ) -> Tuple[List[Tuple[int, int, int]], int]:
    """The pruned introsort loop (pengnative.cpp ``pruned_introsort_loop``)
    over the whole table, on the device, for every range longer than
    HOST_RANGE: (the ranges left to the host as (first, last, depth),
    the number of partitions run).  The right part of a partition is
    worked only where its cut lies below ``keep_end``, as there."""
    n = z.numel()
    todo = [(0, n, 2 * (n.bit_length() - 1))]
    left, parts = [], 0
    while todo:
        first, last, depth = todo.pop()
        if last - first <= HOST_RANGE or depth == 0:
            left.append((first, last, depth))
            continue
        cut = _partition(z, ids, first, last)
        parts += 1
        if cut < keep_end:
            todo.append((cut, last, depth - 1))
        todo.append((first, cut, depth - 1))
    return left, parts


def sorted_prefix(z: torch.Tensor, expected: torch.Tensor, keep: int
                  ) -> SeedPrefix:
    """The prefix [0, keep] of the descending z-order, as
    zscore_sort_prefix gives it, from the device's ``z`` and
    ``expected`` tables: the large partitions on the device, then one
    fetch of the pairs [0, R) and their expected counts, and the host's
    finish.  Counts the device's partitions in
    ``seeds.card_partitions``."""
    n = z.numel()
    keep_end = keep + 1
    zw = z.clone()
    ids = torch.arange(n, dtype=torch.int32, device=z.device)
    left, parts = device_partitions(zw, ids, keep_end)
    count("seeds.card_partitions", parts)
    fin = min(n, keep_end + _THRESHOLD)
    r = max([fin] + [last for _, last, _ in left])
    pairs = sync_read(torch.stack([
        zw[:r].view(torch.int32), ids[:r],
        expected[ids[:r].long()].view(torch.int32)])).numpy()
    z_r = pairs[0].view(np.float32)
    perm = seed_sort_finish_native(z_r, left, keep_end, fin)[:keep_end]
    return SeedPrefix(pairs[1].view(np.uint32)[perm], z_r[perm],
                      pairs[2].view(np.float32)[perm])
