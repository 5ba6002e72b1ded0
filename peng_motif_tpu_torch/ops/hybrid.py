"""Where the count phase counts: on the card or on the host.

Counterpart of ``peng_motif_tpu/ops/hybrid.py``.  The count phase runs
either on the card (pack, pageable upload, the device scan, the fetch of
the canonical slice, the host mirror and fix-up of the fetched table) or
on the host's threaded native scan (``count_rows_exact_native`` + the
background (k+1)-mer scan), always over the whole corpus.  A device count
pays a fixed cost whatever the corpus (at W >= 11 most of a second: the
fetch, host mirror and fix-up of the 4**W table), so below a crossover
the host count alone is faster; :func:`count_on_host` decides from the
device, the table width and the corpus size.

The reference package can also split the corpus between the two ends;
the port does not: on the card's machine the two shares draw on the same
host cores, and a split lost to the better end at every width measured
(README, "The host+device co-count").
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..models.background import count_kmers
from ..native import count_rows_exact_native
from ..utils.logging_utils import span

__all__ = ["count_on_host", "host_count"]

# The largest corpus, in bases, that a W >= 11 count takes to the host:
# where B / h < B / d + lat stops holding for the walls of
# engine._count_phase with the whole corpus on the card (d = 463 Mbases/s
# beyond a fixed cost lat = 0.854 s: the 4**12 table's fetch, host
# mirror and fix-up) and with the whole corpus on the host (h = 77.6
# Mbases/s), on 8 sequences and on 51.2 Mbases, as chip_smoke.py's
# "hybrid" phase measures them, on "NVIDIA H100 80GB HBM3, 700.00 W" with
# 8 host cores.  At W <= 10 the card won at every size (its fixed cost is
# below the host count's), so those widths always count on the card.
# The host walls predate the host count of csrc/hostcount.cpp, which cut
# MafK's (1 Mbase) at W = 12 from 0.48 to 0.045 s: the crossover has not
# been re-measured since and now lies too low (ROADMAP D1).
HOST_MAX_BASES = 79_613_895


def count_on_host(device, total_bases: int, W: int) -> bool:
    """True where the host's native scan counts the whole corpus: on a
    CUDA device, at W >= 11, over at most :data:`HOST_MAX_BASES` bases.
    Everywhere else the device counts it."""
    return (torch.device(device).type == "cuda" and W >= 11
            and total_bases <= HOST_MAX_BASES)


def _host_rows(sequences: Sequence[np.ndarray], lengths: np.ndarray,
               flat: Optional[np.ndarray]) -> np.ndarray:
    """[nB, Lmax] uint8 rows of the corpus (zero padding == undefined
    base, the count scan's window-validity sentinel — same contract as
    SequenceSet.padded).  Uniform-length corpora with a contiguous parse
    buffer reshape zero-copy."""
    lens = lengths.astype(np.int64)
    if lens.size == 0:
        return np.zeros((0, 1), dtype=np.uint8)
    lmax = int(lens.max())
    if (flat is not None and int(lens.min()) == lmax
            and flat.shape[0] == lens.size * lmax):
        return flat.reshape(lens.size, lmax)
    out = np.zeros((lens.size, lmax), dtype=np.uint8)
    if flat is not None and flat.shape[0] == int(lens.sum()):
        mask = np.arange(lmax)[None, :] < lens[:, None]
        out[mask] = flat
        return out
    for i, s in enumerate(sequences):
        out[i, : len(s)] = np.asarray(s, dtype=np.uint8)
    return out


def host_count(sequences: Sequence[np.ndarray], lengths: np.ndarray,
               flat: Optional[np.ndarray], W: int, both_strands: bool,
               bg_order: int = -1):
    """(table int32 [4**W] mirrored, ltot, bg counts list | None): the
    threaded native count of the whole corpus (+ the background scan when
    ``bg_order >= 0``), on the calling thread.  Span ``host``, with the
    native count's ``scan`` and ``mirror`` inside."""
    with span("host"):
        rows = _host_rows(sequences, lengths, flat)
        table, ltot = count_rows_exact_native(rows, W, both_strands)
        bg = count_kmers(sequences, bg_order) if bg_order >= 0 else None
    return table, int(ltot), bg
