"""Adaptive host+device co-counting for the stream count phase.

Counterpart of ``peng_motif_tpu/ops/hybrid.py``.  The count phase can
run on the card (pack, pageable upload, the device scan, the fetch of the
canonical slice, the host mirror and fix-up of the fetched table), on the
host's threaded native scan (``count_rows_exact_native`` + the background
(k+1)-mer scan), or on both side by side over a split corpus.  The
planner picks by the table width and the corpus size.  A device count
pays a fixed cost whatever the corpus (at W = 12 most of a second: the
host mirror of the 4**12 table), so below a crossover the host scan alone
is faster and the whole count stays on the host; above it the card
counts everything.  A split is planned only where the host's rate is
known to hold beside the device share (``PENG_HOST_SCAN_BASES_S``): on
the machine the defaults were measured on the two shares draw on the same
cores and a split loses to both ends.

The split is exact, not approximate: every count-phase quantity is
per-sequence additive —

  * the W-mer table: windows never span sequences (reference:
    src/base_pattern.cpp:331-393 resets at sequence ends), so
    table(corpus) = table(A) + table(B) bin-wise, and the greedy
    non-overlap dedup is per-sequence too;
  * ltot adds; the device dedup fix-up (seam certificates) only
    concerns the device share's stream;
  * background (k+1)-mer counts add per sequence
    (models/background.py count_kmers is the per-sequence oracle).

The device share keeps the resident table and all table-parallel phases
(stats DP, lockstep climb, adv-PWM, EM) on the device; the host share's
table is added to the resident table by the stats program
(engine.ResidentState.host_add), or uploaded as the resident table when
the host counted everything.

``PENG_HYBRID_DEVICE_FRAC`` overrides the planner (1 = pure device, 0 =
host-only count); ``PENG_WIRE_BASES_S`` (the device count's rate, bases
per second), ``PENG_HOST_SCAN_BASES_S`` (the host scan's rate, taken to
hold beside a device share too) and ``PENG_DEVICE_LATENCY_S`` (the device
count's fixed cost) recalibrate the cost model for another machine.
"""

from __future__ import annotations

import os
import threading
from typing import Optional, Sequence

import numpy as np

from ..models.background import count_kmers
from ..native import count_rows_exact_native
from ..utils.logging_utils import start_thread

__all__ = [
    "HostShare",
    "plan_device_fraction",
    "split_index",
    "start_host_share",
]


def _env_f(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


# The cost model's defaults, by table width (W <= 8, W <= 10, wider): the
# walls of engine._count_phase with the whole corpus on the card and with
# the whole corpus on the host, on 8 sequences and on 25,000 (51.2
# Mbases, 2,048 bp each), as chip_smoke.py's "hybrid" phase measures and
# fits them, on "NVIDIA H100 80GB HBM3, 700.00 W" with 8 host cores.
#
# lat: the device count's wall less the host count's on 8 sequences.  At
# W = 12 the device count pays the fetch, the host mirror and the fix-up
# of a 4**12 table whatever the corpus holds (1.40 s against 0.55 s); at
# W <= 10 the host count is the one that starts slower (0.018 against
# 0.009 s, 0.048 against 0.041 s), so the card counts every corpus there.
# d, h: the bases each end adds per second of count phase from the small
# corpus to the large one (card 0.142 / 0.161 / 1.515 s, host 0.322 /
# 0.509 / 1.210 s at 51.2 Mbases).  At W = 12 the ends cross at 80 Mbases;
# measured between, the host count won at 1 Mbase (0.52 against 1.36 s),
# at 10.2 Mbases (0.70 against 1.41 s) and at 51.2 Mbases.  A second run
# put the crossover higher (lat 0.996 s, h 142 Mbases/s, the card's rate
# lost in the 0.1 s spread of its fixed cost: 141 Mbases); the defaults
# keep the lower one.  The host walls were measured before the host count
# of csrc/hostcount.cpp, which cut MafK's (1 Mbase) at W = 12 from 0.48 to
# 0.045 s on the H100's 8-core host; the constants are not re-fit, so the
# W = 12 crossover now lies above the 80 Mbases they give.
_DEVICE_BASES_S = (384e6, 427e6, 463e6)
_HOST_BASES_S = (168e6, 111e6, 77.6e6)
_DEVICE_LATENCY_S = (-0.009, -0.007, 0.854)


def _by_width(rates, W: int) -> float:
    return rates[0 if W <= 8 else (1 if W <= 10 else 2)]


def plan_device_fraction(total_bases: int, W: int = 8) -> float:
    """Wall-optimal device share f in [0, 1].

    Cost model: device wall = f*B/d + lat (d the device count's rate, lat
    its fixed cost), host wall = (1-f)*B/h (threaded native count + bg
    scan).

    By default the planner compares the two ends, B/h against B/d + lat,
    and returns 0.0 (host-only count: small corpora, wide tables) or 1.0:
    measured, the host scan beside a device share adds no rate (both draw
    on the same cores), so no split beats the better end.

    With ``PENG_HOST_SCAN_BASES_S`` set, h is taken to hold beside the
    device share (a host with cores to spare), and minimizing
    max(device wall, host wall) equalizes the two:

        f* = (B/h - lat) / (B/d + B/h),  clipped to [0, 1]

    f* <= 0 (small corpora) means the host scan alone beats any split
    that pays the device share's fixed cost -> host-only count.  h <= 0
    -> pure device count.
    """
    forced = os.environ.get("PENG_HYBRID_DEVICE_FRAC")
    if forced is not None:
        try:
            return min(1.0, max(0.0, float(forced)))
        except ValueError:
            pass
    d = _env_f("PENG_WIRE_BASES_S", _by_width(_DEVICE_BASES_S, W))
    lat = _env_f("PENG_DEVICE_LATENCY_S", _by_width(_DEVICE_LATENCY_S, W))
    if total_bases <= 0 or d <= 0:
        return 0.0
    try:
        h = float(os.environ["PENG_HOST_SCAN_BASES_S"])
    except (KeyError, ValueError):
        h = _by_width(_HOST_BASES_S, W)
        return 0.0 if total_bases / h < total_bases / d + lat else 1.0
    if h <= 0:
        return 1.0
    b_h = total_bases / h
    f = (b_h - lat) / (total_bases / d + b_h)
    return min(1.0, max(0.0, f))


def split_index(lengths: np.ndarray, frac: float):
    """(ja, off): device share = sequences[:ja] (first ``off`` flat
    bases), host share = sequences[ja:].  ``ja`` is the smallest prefix
    holding >= frac of the bases; frac >= 1 maps to the whole corpus."""
    n = int(lengths.shape[0])
    if n == 0 or frac >= 1.0:
        return n, int(lengths.sum())
    if frac <= 0.0:
        return 0, 0
    cum = np.cumsum(lengths.astype(np.int64))
    target = frac * float(cum[-1])
    ja = int(np.searchsorted(cum, target, side="left")) + 1
    ja = min(ja, n)
    return ja, int(cum[ja - 1]) if ja > 0 else 0


def _host_rows(sequences: Sequence[np.ndarray], lengths: np.ndarray,
               flat: Optional[np.ndarray], off: int) -> np.ndarray:
    """[nB, Lmax] uint8 rows for the host share (zero padding ==
    undefined base, the count scan's window-validity sentinel — same
    contract as SequenceSet.padded).  Uniform-length corpora with a
    contiguous parse buffer reshape zero-copy."""
    lens = lengths.astype(np.int64)
    if lens.size == 0:
        return np.zeros((0, 1), dtype=np.uint8)
    lmax = int(lens.max())
    if (flat is not None and int(lens.min()) == lmax
            and flat.shape[0] - off == lens.size * lmax):
        return flat[off:].reshape(lens.size, lmax)
    out = np.zeros((lens.size, lmax), dtype=np.uint8)
    if flat is not None and flat.shape[0] - off == int(lens.sum()):
        mask = np.arange(lmax)[None, :] < lens[:, None]
        out[mask] = flat[off:]
        return out
    for i, s in enumerate(sequences):
        out[i, : len(s)] = np.asarray(s, dtype=np.uint8)
    return out


class HostShare:
    """Handle on the host share's scan thread (its wall is the span
    ``host_thread`` of the job's recorder)."""

    def __init__(self, thread: threading.Thread, box: list):
        self._thread = thread
        self._box = box

    def join(self):
        """(table int32 [4**W] mirrored, ltot, bg counts list | None);
        raises what the scan thread raised."""
        self._thread.join()
        result = self._box[0]
        if isinstance(result, BaseException):
            raise result
        return result


def start_host_share(
    sequences: Sequence[np.ndarray],
    lengths: np.ndarray,
    flat: Optional[np.ndarray],
    off: int,
    W: int,
    both_strands: bool,
    bg_order: int = -1,
) -> HostShare:
    """Begin the host share's threaded native count scan (+ bg scan when
    ``bg_order >= 0``) over ``sequences`` — the suffix the planner kept
    off the card.  Overlaps the device share's pack, upload and scan;
    join() after the device share's fetch."""
    seqs = list(sequences)
    lens = np.asarray(lengths, dtype=np.int64)
    box: list = [None]

    def _run():
        try:
            rows = _host_rows(seqs, lens, flat, off)
            table, ltot = count_rows_exact_native(rows, W, both_strands)
            bg = count_kmers(seqs, bg_order) if bg_order >= 0 else None
            box[0] = (table, int(ltot), bg)
        except BaseException as e:  # noqa: BLE001 - rethrown in join()
            box[0] = e

    return HostShare(start_thread("host_thread", _run), box)
