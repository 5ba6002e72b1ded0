"""The device engine: count phase on the torch device, phases 2-5 on the
byte-exact host twins.

Counterpart of ``peng_motif_tpu/engine_tpu.py::process_tpu`` on its
single-device branch:

  1. count: the gap-packed halo-chunk stream (ops/stream_count.py) is
     packed on host, copied to the device, and counted there — the 4**W
     table and the fused background (k+1)-mer table both come out of the
     histogram kernel (ops/histogram.py).  The canonical slice, ltot,
     the suspicion flags and the background table come back; the host
     mirrors the table and applies the exact fix-up for suspicious
     chunks.
  2. host statistics and seed selection (native, byte-exact);
  3. climb, PWM, EM and merging on the reference's host twins
     (pattern_tables.PatternTables over the counted table, native EM).

Integer results (counts, ltot, background counts, seed selection) are
exact; phases 2-5 are the reference package's byte-exact host code, so
the output equals the golden files byte for byte.
"""

from __future__ import annotations

import sys
from typing import List

import numpy as np
import torch

from .alphabets import base_id_to_string
from .models.background import bg_device_corrections
from .models.motif import MIN_MERGE_OVERLAP, Motif
from .native import (
    base_stats_native,
    bg_prob_table_native_fn,
    mirror_canonical_native,
    select_patterns_walk_native,
    zscore_sort_prefix_indices,
)
from .ops.stream_count import (
    bg_offset,
    build_stream,
    chunked_packed,
    chunked_packed2,
    from_reference_buffer,
    stream_count_device_fused,
    stream_count_device_fused2,
    stream_fixup_pairs,
    wire2_eligible,
)
from .pattern_tables import PatternTables, Strand


class NotPortedError(RuntimeError):
    """A feature of the reference package that this package does not
    run yet."""


# what ran the last process_gpu call, reset at its entry: the engine
# ("gpu" on a CUDA device, "cpu" on the CPU), and where the climb and
# the PWM/EM phases ran ("host": the byte-exact host twins)
LAST_ENGINE_USED = None
LAST_CLIMB_ENGINE = None
LAST_PWM_ENGINE = None


# ---------------------------------------------------------------------------
# count phase
# ---------------------------------------------------------------------------


def _mirror_host(vals: np.ndarray, W: int, both: bool) -> np.ndarray:
    """Expand the canonical-compacted device slice to the full mirrored
    host table (reference mirror step: src/base_pattern.cpp:386-392)."""
    if not both:
        return np.asarray(vals, dtype=np.int32).copy()
    return mirror_canonical_native(vals, W)


def _deliver_bg(bgm, bg_words, bg_corr):
    """Split the fetched fused histogram into per-order vectors, add the
    host corrections, and hand the counts to the deferred model."""
    words = np.asarray(bg_words, dtype=np.int64)
    bgm.provide_counts([
        words[bg_offset(k) : bg_offset(k) + 4 ** (k + 1)] + bg_corr[k]
        for k in range(bgm.order + 1)])


def count_on_device(sequences, W: int, both: bool, device, bg_order: int,
                    flat=None, n_undef=None):
    """Device stream count of ``sequences``: (stream, layout, out), with
    ``out`` the device tuple of ``stream_count_device_fused(2)`` —
    (mirrored counts, canonical vals, ltot, suspicion, bg) — before the
    host fix-up (ops/stream_count.stream_fixup_pairs)."""
    stream, lay = build_stream(sequences, W, flat_codes=flat)
    wire2 = n_undef is not None and wire2_eligible(lay, n_undef)
    packed = chunked_packed2(stream, lay) if wire2 else chunked_packed(
        stream, lay)
    buf, meta = from_reference_buffer(packed, lay, wire2, device)
    if wire2:
        out = stream_count_device_fused2(buf, meta, lay.row, lay.ctx, W,
                                         both, bg_order)
    else:
        out = stream_count_device_fused(buf, lay.row, lay.ctx, W, both,
                                        bg_order)
    return stream, lay, out


def _fetch(out):
    """Host copies of a device count's non-resident outputs: (vals int32,
    ltot, susp bool, bg int32 or None)."""
    _counts, vals, ltot, susp, bg = out
    return (vals.cpu().numpy(), int(ltot), susp.cpu().numpy(),
            None if bg is None else bg.cpu().numpy())


def _count_phase(peng, W: int, both: bool, device):
    """(counts_host int32 [4**W] mirrored and exact, ltot): the device
    count with its host completions, under the reference's
    background-deferral gates (engine_tpu.py:808-827)."""
    sset = peng.sequence_set
    bgm = peng.bg_model
    flat = getattr(sset, "_flat_codes", None)
    if flat is not None and flat.shape[0] != sset.total_bases:
        flat = None  # stale parse buffer: never slice by offset
    n_undef = getattr(sset, "n_undefined", None)
    if n_undef is None and flat is not None:
        n_undef = int(np.count_nonzero(flat == 0))
    # fused device background counting: when the CLI deferred the bg
    # model (bg set == input set), the (k+1)-mer histogram rides the
    # count and two O(#seqs + #Ns) host corrections complete it
    defer_bg = (bgm.deferred and bgm.order <= 3 and 2 * (W - 1) >= 8)
    if defer_bg and flat is not None and flat.shape[0] >= 1_500_000_000:
        # int32 bg-bin headroom: an order-0 bin holds up to one count
        # per base — past ~1.5 Gbases take the threaded host scan
        defer_bg = False
    if defer_bg and flat is not None and n_undef > 20_000_000:
        # mass-N corpora: the per-N correction scan would rival the host
        # bg scan it replaces
        defer_bg = False
    bg_order = bgm.order if defer_bg else -1
    if not defer_bg:
        bgm.start_host_counting()  # no-op unless deferred

    stream, lay, out = count_on_device(
        sset.sequences, W, both, device, bg_order, flat=flat,
        n_undef=n_undef)
    if defer_bg:
        # host completion of the fused histogram (models/background.py),
        # computed while the device count is in flight
        bg_corr = bg_device_corrections(
            sset.sequences, bgm.order, flat_codes=flat, lengths=lay.lengths)
    vals, ltot, susp_np, bg_words = _fetch(out)
    if defer_bg:
        _deliver_bg(bgm, bg_words, bg_corr)
    counts_host = _mirror_host(vals, W, both)
    fix_ids, fix_dv, ltot_delta = stream_fixup_pairs(
        stream, lay, susp_np, both)
    ltot += ltot_delta
    np.add.at(counts_host, fix_ids, fix_dv)
    if ltot >= (1 << 31):
        raise NotPortedError(
            f"ltot = {ltot} >= 2**31 (int32 count-table bound); the "
            "wide-corpus path is not yet ported to peng_motif_tpu_torch")
    return counts_host, ltot


# ---------------------------------------------------------------------------
# host statistics and seed selection
# ---------------------------------------------------------------------------


def _host_bg_flat(v, W: int, order: int, both: bool) -> np.ndarray:
    """Host background table in the reference's exact fold order."""
    v_host = [np.asarray(vk, dtype=np.float32) for vk in v[: order + 1]]
    return bg_prob_table_native_fn(v_host, W, order, both)


def _select_seeds_host(z: np.ndarray, counts: np.ndarray, W: int,
                       zthr: float, count_thr: int, single: bool,
                       filter_neighbors: bool) -> List[int]:
    """Byte-exact seed selection: libstdc++ z-sort (native, reproducing
    the reference binary's tie placement) + the greedy threshold walk
    (reference: src/base_pattern.cpp:443-515)."""
    order = zscore_sort_prefix_indices(z, float(zthr))
    return [int(p) for p in select_patterns_walk_native(
        order, z, counts, W, float(zthr), count_thr, single,
        filter_neighbors)]


def _host_climb(peng, params, selected, counts_host, ltot, W: int,
                order_k: int, order_max: int):
    """Byte-exact host climb over the counted table (native batched
    scoring).  Returns (candidates, tables); the tables serve the host
    PWM/EM twins."""
    tables = PatternTables(
        W, peng.strand, order_k, order_max, peng.bg_model,
        peng.n_sequences, precomputed=(counts_host, int(ltot)))
    return peng._optimize_iupac_patterns(
        params.opt_score_type, tables, selected,
        params.enrich_pseudocount_factor), tables


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def process_gpu(peng, params) -> List[Motif]:
    """Counterpart of Peng.process (src/peng.cpp:322-435) with the count
    phase on ``params.device``.  Degenerate inputs (no sequences, or all
    shorter than W) count nothing and run a zero table through the same
    host chain."""
    global LAST_ENGINE_USED, LAST_CLIMB_ENGINE, LAST_PWM_ENGINE
    LAST_ENGINE_USED = LAST_CLIMB_ENGINE = LAST_PWM_ENGINE = None
    device = torch.device(params.device)

    W = params.max_pattern_length
    both = peng.strand == Strand.BOTH_STRANDS
    sset = peng.sequence_set
    out = peng.out
    peng._status(f"Processing kmers of length {W}", leading_newline=False)
    peng._status("Finding overrepresented kmers (base patterns)",
                 leading_newline=False)

    current_k = min(W - 1, peng.k)
    current_max_k = min(W - 1, peng.max_k)

    # -- phase 1: count (device) + byte-exact host selection (the z-score
    # seed sort must reproduce libstdc++ tie placement, reference:
    # src/base_pattern.cpp:443-458) --------------------------------------
    with peng.timer.phase("count"):
        if sset.n == 0 or sset.max_l < W:
            peng.bg_model.start_host_counting()
            counts_host, ltot = np.zeros(4 ** W, dtype=np.int32), 0
        else:
            counts_host, ltot = _count_phase(peng, W, both, device)
        # (expected, zscores) with the reference's float promotion points
        # (reference: src/base_pattern.cpp:252-265)
        bgp_host = _host_bg_flat(peng.bg_model.v, W, current_k, both)
        expected_host, z_host = base_stats_native(counts_host, bgp_host, ltot)
        selected = _select_seeds_host(
            z_host, counts_host, W, params.zscore_threshold,
            params.count_threshold, peng.strand == Strand.PLUS_STRAND,
            params.filter_neighbors)

    if not selected:
        print("No overrepresented seed patterns found. Stopping.", file=out)

    # seed table (reference: src/base_pattern.cpp:517-532)
    print(f"{'pattern':>15}\t{'observed':>15}\t{'enrichment':>15}\t"
          f"{'zscore':>15}\n", file=out)
    for pid in selected:
        obs = int(counts_host[pid])
        enr = obs / expected_host[pid]
        print(f"{base_id_to_string(pid, W):>15}\t{obs:>15}\t"
              f"{enr:>15.2f}\t{z_host[pid]:>15.2f}", file=out)

    peng._status("Optimizing base patterns")
    print(file=out)
    if len(selected) > params.max_optimized_patterns:
        selected = selected[: params.max_optimized_patterns]

    # -- phase 2: the climb (reference: src/peng.cpp:437-541) -------------
    with peng.timer.phase("optimize"):
        candidates, tables = _host_climb(
            peng, params, selected, counts_host, ltot, W,
            current_k, current_max_k)
    LAST_CLIMB_ENGINE = "host"

    print(file=out)
    peng._status("Filtering degenerated IUPAC patterns")
    candidates = peng._filter_iupac_patterns(
        W, params.minimum_processed_motifs, candidates)
    for motif in candidates:
        print(f"selected iupac pattern: {motif.iupac_string()}", file=out)

    # -- phases 3 + 4: PWMs, EM, merging (reference:
    # src/peng.cpp:372-435) -----------------------------------------------
    peng._status("Calculating PWMs")
    # the reference prints and tags the *unclamped* max_k
    # (src/peng.cpp:397-399); tables are clamped to W-1
    background = peng.max_k
    table_order = min(background, W - 1)
    with peng.timer.phase("pwm"):
        peng._calculate_pwms(tables, candidates, params)
    peng._status("Optimizing expectation-maximization / merging patterns")
    print(f"\nbackground order: {background}", file=out)
    with peng.timer.phase("em+merge"):
        if params.use_em:
            optimized = peng._em_optimize(
                candidates, tables, params.em_saturation_factor,
                params.em_min_threshold, params.em_max_iterations,
                table_order, params.threads)
        else:
            optimized = candidates
        if params.use_merging:
            if W >= MIN_MERGE_OVERLAP:
                peng._merge_patterns(
                    W, params.bit_factor_merge_threshold, optimized,
                    params.max_merged_length)
            else:
                print(f"Warning: Specified pattern length ({W}) is too "
                      "low for merging!", file=sys.stderr)
    LAST_PWM_ENGINE = "host"

    for motif in optimized:
        motif.opt_bg_order = background
    LAST_ENGINE_USED = "gpu" if device.type == "cuda" else "cpu"
    return optimized
