"""The device engine: the five device programs of the main path.

Counterpart of ``peng_motif_tpu/engine_tpu.py::process_tpu``.  Every
4**W table stays on the torch device from counting to EM (with
``params.mesh`` the count is sharded over the mesh's devices,
parallel/sharded.py, and the table is resident on its first; with
``params.precomputed`` the multi-process count, parallel/multihost.py,
has already produced it):

  1. count   — the gap-packed halo-chunk stream (ops/stream_count.py) is
               packed on host, copied to the device and counted there by
               the histogram kernel (ops/histogram.py); the mirrored
               table stays resident, the canonical slice, ltot, the
               suspicion flags and the background table come back.  On a
               CUDA device without a mesh, a wide table over a small
               corpus is counted by the host's native scan instead
               (ops/hybrid.py), whose table becomes the resident one.
  2. stats   — :func:`stats_program`: the host fix-up of suspicious
               chunks added to the resident table, background
               probabilities, expected counts and z-scores
               (ops/flat_tables); the seed z-sort's large partitions
               (ops/seed_sort.py).
  3. climb   — ops/climb.run_walks: all hill-climb walks in lockstep;
               the host replays the seen set and writes the climb's
               rows in one native pass (climb.replay, csrc/replay.cpp).
  4. PWM     — :func:`adv_pwm_program`: letter-substitution sums and
               the reference's integer pseudo-count arithmetic.
  5. EM      — ops/em.em_optimize_flat, batched over motifs.

The seed sort's finish and walk, filtering, merging and the redundancy
filter stay on the host (native, byte-exact), as in the reference.

Where the reference engine cannot guarantee the reference's semantics,
it raises :class:`EngineFallback` and pipeline.Peng.process reruns the
exact engine; the port raises it at the same four points
(engine_tpu.py:741-743, :786-789, :1028-1030, :1141-1142): degenerate
input, no usable checkpoint, ltot >= 2**31 and climb overflow.

Parity contract (the reference engine's, engine_tpu.py:23-37): integer
quantities (counts, ltot, seed selection, climb decisions and
aggregates, adv-PWM cells) are identical; float statistics may differ in
the last ulps (device reduction order, libm), and EM's saturated
iterations amplify that to a few 1e-6 per PWM cell — 5e-6 absolute plus
1e-6 relative on the written files.
"""

from __future__ import annotations

import sys
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from .alphabets import (
    IUPAC_MASKS,
    LOG_BONFERRONI,
    base_id_to_string,
    digits_to_iupac_id,
    iupac_id_to_digits,
)
from .checkpoint import load_checkpoint, save_checkpoint
from .models.background import bg_device_corrections
from .models.motif import MIN_MERGE_OVERLAP, Motif
from .native import (
    mirror_canonical_native,
    seed_walk_prefix_native,
    zscore_sort_prefix_indices,
)
from .ops import flat_tables as ft
from .ops import hybrid as hy
from .ops.climb import ClimbOverflow, WalkTrace, replay, run_walks
from .ops.em import em_optimize_flat
from .ops.seed_sort import SeedPrefix, device_keep, sorted_prefix
from .ops.stream_count import bg_offset, stream_fixup_pairs
from .parallel.sharded import stream_count_sharded
from .pattern_tables import Strand
from .utils import numerics
from .utils.logging_utils import count, span, sync_read, upload

F32 = np.float32


class EngineFallback(Exception):
    """The device engine cannot guarantee the reference's semantics for
    this run (degenerate input, no usable checkpoint, ltot >= 2**31,
    climb overflow); the caller reruns the exact engine."""


# what ran the last run, reset at the entry of pipeline.Peng.process:
# the engine ("gpu" or "cpu" for the device engine on a CUDA device or
# on the CPU, "exact" for the exact engine), and where the climb and the
# PWM/EM phases ran ("device": the torch programs on that device;
# "host": the exact engine's native phases)
LAST_ENGINE_USED = None
LAST_CLIMB_ENGINE = None
LAST_PWM_ENGINE = None
# where the last device-engine run counted (ops/hybrid.count_on_host):
# 1.0 on the device, 0.0 on the host; None when the run did not count
# through the single-device path (a mesh, a checkpoint or a precomputed
# table, the exact engine)
LAST_HYBRID_FRAC = None


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
    bgm.provide_counts(
        [words[bg_offset(k) : bg_offset(k) + 4 ** (k + 1)] + bg_corr[k]
         for k in range(bgm.order + 1)])


def _fetch(out):
    """Host copies of the non-resident outputs of the device count
    (parallel/sharded.stream_count_sharded's ``out``): (vals int32, ltot,
    susp bool, bg int32 or None)."""
    _counts, vals, ltot, susp, bg = out
    return (sync_read(vals).numpy(), sync_read(ltot, int),
            sync_read(susp).numpy(),
            None if bg is None else sync_read(bg).numpy())


def _count_phase(peng, W: int, both: bool, device, mesh=None):
    """(counts_host, ltot, counts_dev, fix_ids, fix_dv): the count of the
    whole corpus with its host completions, under the reference's
    background-deferral gates (engine_tpu.py:808-827).  ``counts_host``
    is the exact mirrored table; ``counts_dev`` is the resident device
    table before :func:`stats_program` adds the fix-up pairs (``fix_ids``,
    ``fix_dv``) to it.  The chunks shard over ``mesh``
    (parallel/sharded.stream_count_sharded; one shard on ``device``
    without a mesh) and the table is resident on the mesh's first device.

    Without a mesh, where ops/hybrid.count_on_host says so, the host's
    native scan counts the corpus instead (span ``host``): its table is
    the resident table, with an empty fix-up."""
    global LAST_HYBRID_FRAC
    sset = peng.sequence_set
    bgm = peng.bg_model
    flat = getattr(sset, "_flat_codes", None)
    if flat is not None and flat.shape[0] != sset.total_bases:
        flat = None  # stale parse buffer: never read it as the corpus
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

    if mesh is None:
        on_host = hy.count_on_host(device, sset.total_bases, W)
        LAST_HYBRID_FRAC = 0.0 if on_host else 1.0
        if on_host:
            table, ltot, bg = hy.host_count(sset.sequences, sset._lengths(),
                                            flat, W, both, bg_order)
            if defer_bg:
                bgm.provide_counts(bg)  # the host oracle, exact
            none = np.zeros(0, dtype=np.int32)
            return table, ltot, table, none, none

    stream, lay, out = stream_count_sharded(
        sset.sequences, W, both, mesh or (torch.device(device),),
        flat_codes=flat, bg_order=bg_order, n_undefined=n_undef)
    if defer_bg:
        # host completion of the fused histogram (models/background.py),
        # computed while the device count (every shard's) is in flight
        with span("bg_correct"):
            bg_corr = bg_device_corrections(
                sset.sequences, bgm.order, flat_codes=flat,
                lengths=lay.lengths)
    with span("fetch"):
        vals, ltot, susp_np, bg_words = _fetch(out)
    if defer_bg:
        _deliver_bg(bgm, bg_words, bg_corr)
    with span("fixup"):
        counts_host = _mirror_host(vals, W, both)
        fix_ids, fix_dv, ltot_delta = stream_fixup_pairs(
            stream, lay, susp_np, both)
        ltot += ltot_delta
        np.add.at(counts_host, fix_ids, fix_dv)
    return counts_host, ltot, out[0], fix_ids, fix_dv


# ---------------------------------------------------------------------------
# device programs
# ---------------------------------------------------------------------------


class ResidentState(NamedTuple):
    """The count phase's output on the device: what the stats program
    reads in place of weights."""

    counts: torch.Tensor      # [4**W] int32 mirrored table, before fix-up
    ltot: int                 # host-corrected processed-window count
    fix_ids: torch.Tensor     # [F] int64 ids of the host fix-up
    fix_dv: torch.Tensor      # [F] int32 count deltas of the host fix-up
    v: tuple                  # per-order f32 conditional bg tables


def resident_state(counts, ltot: int, fix_ids, fix_dv,
                   v: Sequence[np.ndarray], device) -> ResidentState:
    """The device inputs of :func:`stats_program` from the count phase's
    arrays — numpy (or a table already on ``device``): the same arrays
    the reference engine hands its stats program (engine_tpu.py:1038)."""
    device = torch.device(device)
    return ResidentState(
        counts=upload(counts, device, torch.int32),
        ltot=int(ltot),
        fix_ids=upload(np.asarray(fix_ids), device, torch.int64),
        fix_dv=upload(np.asarray(fix_dv), device, torch.int32),
        v=tuple(upload(np.asarray(vk, dtype=np.float32), device)
                for vk in v))


def stats_program(state: ResidentState, length: int, order_k: int,
                  order_max: int, both: bool) -> dict:
    """Sparse dedup fix-up + background DP + expected counts (reference:
    src/base_pattern.cpp:231-325; engine_tpu.py:197-222), all on the
    state's device: counts (int32, the whole corpus's exact table), bgp,
    expected and z (order ``order_k``; expected and z are
    base_stats_table's bit for bit), bg_max (order ``order_max``), each
    [4**W]."""
    counts = state.counts.clone()
    counts.index_add_(0, state.fix_ids, state.fix_dv)
    bgp = ft.bg_prob_flat(state.v, length, order_k)
    if both:
        bgp = ft.aggregate_double_strand_flat(bgp, length)
    expected = bgp * float(np.float32(state.ltot))
    # z with the reference's promotion points (src/base_pattern.cpp:
    # 252-265, pengnative.cpp base_stats_table): the numerator in f32, the
    # division by the square root in f64
    zscores = ((counts.to(torch.float32) - expected).to(torch.float64)
               / expected.to(torch.float64).sqrt()).to(torch.float32)
    if order_max != order_k:
        bg_max = ft.bg_prob_flat(state.v, length, order_max)
        if both:
            bg_max = ft.aggregate_double_strand_flat(bg_max, length)
    else:
        bg_max = bgp
    return dict(counts=counts, bgp=bgp, expected=expected, z=zscores,
                bg_max=bg_max)


def _adv_sub_counts(digit_mat: torch.Tensor, counts_flat: torch.Tensor,
                    length: int, both: bool, wide: bool = False):
    """Adv-PWM occurrence sums [M, W, 4]: for every motif, position p
    and base a, the aggregate count of the motif with position p
    replaced by a (reference: src/iupac_pattern.cpp:505-536).  Closed
    form in the motifs' single-position / pair marginals.  ``wide``: f64
    chain, exact past 2**24."""
    agg = torch.float64 if wide else torch.float32
    dev = counts_flat.device
    counts_c = counts_flat.to(agg)
    if both:
        counts_c = torch.where(ft.canonical_mask(length, dev), counts_c,
                               torch.zeros((), dtype=agg, device=dev))
    masks_tbl = upload(IUPAC_MASKS, dev, agg)
    half = length // 2
    m = masks_tbl[upload(digit_mat, dev, torch.int64)]        # [M, W, 4]
    marg1 = ft.all_marginals(counts_c, m, length)              # [M, W, 4]
    if not both:
        return marg1
    mrc = m.flip(-2, -1)
    marg2 = ft.all_marginals(counts_c, mrc, length)
    pm = ft.pair_marginals(counts_c, m * mrc, length)          # [M, W/2, 4, 4]
    s2 = marg2.flip(-2, -1)
    ad1 = torch.diagonal(pm.flip(-1), dim1=-2, dim2=-1)        # pm[i,a,3-a]
    ad2 = torch.diagonal(pm.flip(-2), dim1=-2, dim2=-1)        # pm[i,3-a,a]
    upper = ad1 * m[:, half:].flip(-1).flip(-2)
    lower = (ad2 * m[:, :half].flip(-1)).flip(-2)
    s3 = torch.cat([upper, lower], dim=-2)
    return marg1 + s2 - s3


def adv_pwm_program(digit_mat, counts_flat: torch.Tensor,
                    bg0: torch.Tensor, pseudo: int, length: int,
                    both: bool, wide: bool = False) -> torch.Tensor:
    """Adv-PWMs [M, W, 4] f32: letter-substitution count sums plus the
    reference's integer pseudo-count arithmetic
    (src/iupac_pattern.cpp:505-536: int-truncated pseudo counts, integer
    totals, double division, float cells).  Sums are exact integers in
    f32 while ltot < 2**24; ``wide`` switches them to f64."""
    sub = _adv_sub_counts(torch.as_tensor(digit_mat), counts_flat, length,
                          both, wide)
    base = torch.trunc(bg0.to(torch.float32) * float(pseudo)).to(
        torch.int32)                                           # [4]
    i_total = base.to(torch.int64) + torch.round(sub).to(torch.int64)
    n_total = i_total.sum(dim=-1, keepdim=True)
    return (i_total.to(torch.float64)
            / n_total.to(torch.float64)).to(torch.float32)


# ---------------------------------------------------------------------------
# host statistics and seed selection
# ---------------------------------------------------------------------------


def _seed_prefix(st: dict, zthr: float) -> SeedPrefix:
    """The z-sorted prefix the seed walk reads, as the reference binary's
    libstdc++ sort places its ties (src/base_pattern.cpp:443-458), from
    the stats program's z and expected.  Its large partitions run on the
    device (ops/seed_sort.py; span ``sort``); where
    ops/seed_sort.device_keep leaves the whole table to the host, z and
    expected are fetched in one read (span ``fetch``) and sorted by the
    native sort (``sort``).  Counts the device's partitions in
    ``seeds.card_partitions``."""
    keep = device_keep(st["z"], zthr)
    if keep is not None:
        with span("sort"):
            return sorted_prefix(st["z"], st["expected"], keep)
    count("seeds.card_partitions", 0)
    with span("fetch"):
        z, expected = sync_read(
            torch.stack((st["z"], st["expected"]))).numpy()
    with span("sort"):
        order = zscore_sort_prefix_indices(z, float(zthr))
        # the walk stops at the first z below the threshold: at most
        # after the entries that are not below it
        ids = order[: np.count_nonzero(~(z < np.float32(zthr))) + 1]
    return SeedPrefix(ids, z[ids], expected[ids])


def _select_seeds_host(z: np.ndarray, counts: np.ndarray, W: int,
                       zthr: float, count_thr: int, single: bool,
                       filter_neighbors: bool, ids: np.ndarray) -> np.ndarray:
    """The greedy threshold walk (reference: src/base_pattern.cpp:
    443-515) over the z-sorted prefix: ``ids`` its patterns, ``z`` and
    ``counts`` theirs.  Returns the seeds' positions in the prefix, in
    walk order.  Span ``walk``."""
    with span("walk"):
        return seed_walk_prefix_native(ids, z, counts, W, float(zthr),
                                       count_thr, single, filter_neighbors)


# ---------------------------------------------------------------------------
# host-side climb replay and PWM helpers
# ---------------------------------------------------------------------------


def _motif_from_aggregates(digits, W: int, counts: int, expected,
                           bgp) -> Motif:
    m = Motif(digits_to_iupac_id(digits), W)
    m.set_aggregates(int(counts), F32(expected), F32(bgp), LOG_BONFERRONI)
    return m


def _replay_climb(peng, params, trace: WalkTrace, selected, W: int
                  ) -> List[Motif]:
    """Host seen-set replay over the device trajectories; writes the
    reference's climb stdout and returns the surviving motifs
    (reference: src/peng.cpp:437-541)."""
    rp = replay(trace, selected, W)
    peng.out.write(rp.text)
    best_motifs = [
        _motif_from_aggregates(rp.final_digits[s], W, rp.final_counts[s],
                               rp.final_expected[s], rp.final_bgp[s])
        for s in np.flatnonzero(rp.emitted)]
    peng._print_motif_table(best_motifs)
    return best_motifs


def default_pwm(peng, params, motif: Motif, W: int) -> np.ndarray:
    """Reference default-PWM quirk, reproduced faithfully: in default
    mode the per-motif base-pattern list is never populated
    (src/iupac_pattern.cpp:475-503 iterates the always-empty member
    vector), so the PWM reduces to normalized pseudo-counts."""
    bg0 = peng.bg_model.v[0]
    row = np.array(
        [F32(params.pseudo_counts * F32(bg0[a])) for a in range(4)],
        dtype=F32)
    denom = F32(1.0 * motif.n_sites + params.pseudo_counts)
    return np.tile((row / denom).astype(F32), (W, 1))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def process_gpu(peng, params) -> List[Motif]:
    """Counterpart of Peng.process (src/peng.cpp:322-435) with every
    4**W-table phase on ``params.device``.  Raises EngineFallback where
    the reference engine does."""
    global LAST_ENGINE_USED, LAST_CLIMB_ENGINE, LAST_PWM_ENGINE
    device = torch.device(params.device)

    W = params.max_pattern_length
    both = peng.strand == Strand.BOTH_STRANDS
    sset = peng.sequence_set
    if sset.n == 0 or sset.max_l < W:
        raise EngineFallback("degenerate input")
    out = peng.out
    peng._status(f"Processing kmers of length {W}", leading_newline=False)
    peng._status("Finding overrepresented kmers (base patterns)",
                 leading_newline=False)

    current_k = min(W - 1, peng.k)
    current_max_k = min(W - 1, peng.max_k)

    # -- phase 1: count (device, table resident) + byte-exact seed
    # selection (the z-score seed sort must reproduce libstdc++ tie
    # placement, reference: src/base_pattern.cpp:443-458) ----------------
    with peng.timer.phase("count"):
        if params.precomputed is not None or params.load_checkpoint:
            if params.precomputed is not None:
                # externally counted table (the multi-process count,
                # parallel/multihost.py): phases 2-5 run in this process
                loaded = params.precomputed
            else:
                loaded = load_checkpoint(params.load_checkpoint, W,
                                         peng.strand.name)
                if loaded is None:
                    raise EngineFallback("no usable checkpoint")
            # the finished table goes to the device as it is, with an
            # empty fix-up (engine_tpu.py:778-796)
            counts_host = np.asarray(loaded[0], dtype=np.int32)
            ltot = int(loaded[1])
            counts_dev = counts_host
            fix_ids = fix_dv = np.zeros(0, dtype=np.int32)
        else:
            counts_host, ltot, counts_dev, fix_ids, fix_dv = _count_phase(
                peng, W, both, device, mesh=params.mesh)
        if ltot >= (1 << 31):
            # int32 count-table bound
            raise EngineFallback("ltot >= 2**31")
        # past 2**24 the f32 aggregation chains lose integer exactness;
        # the climb and adv-PWM switch to their f64 (wide) variants
        wide = ltot >= (1 << 24)
        with span("upload"):
            state = resident_state(counts_dev, ltot, fix_ids, fix_dv,
                                   peng.bg_model.v[: current_max_k + 1],
                                   device)
        st = stats_program(state, W, current_k, current_max_k, both)
        with span("seeds"):
            prefix = _seed_prefix(st, params.zscore_threshold)
            picks = _select_seeds_host(
                prefix.z, counts_host[prefix.ids], W,
                params.zscore_threshold, params.count_threshold,
                peng.strand == Strand.PLUS_STRAND, params.filter_neighbors,
                prefix.ids)
        selected = [int(prefix.ids[k]) for k in picks]

    if params.save_checkpoint:
        save_checkpoint(params.save_checkpoint, W, peng.strand.name,
                        counts_host, ltot, peng.bg_model)

    if not selected:
        print("No overrepresented seed patterns found. Stopping.", file=out)

    # seed table (reference: src/base_pattern.cpp:517-532)
    print(f"{'pattern':>15}\t{'observed':>15}\t{'enrichment':>15}\t"
          f"{'zscore':>15}\n", file=out)
    for pid, k in zip(selected, picks):
        obs = int(counts_host[pid])
        enr = obs / prefix.expected[k]
        print(f"{base_id_to_string(pid, W):>15}\t{obs:>15}\t"
              f"{enr:>15.2f}\t{prefix.z[k]:>15.2f}", file=out)

    peng._status("Optimizing base patterns")
    print(file=out)
    if len(selected) > params.max_optimized_patterns:
        selected = selected[: params.max_optimized_patterns]

    # -- phase 2: the climb — all walks in lockstep on the device; the
    # host replays the sequential seen-set bookkeeping (reference:
    # src/peng.cpp:437-541; see ops/climb.py) ----------------------------
    with peng.timer.phase("optimize"):
        try:
            trace = run_walks(
                st["counts"], st["expected"], st["bgp"], selected, W, both,
                params.opt_score_type.value, peng.n_sequences,
                int(peng.n_sequences * params.enrich_pseudocount_factor),
                wide=wide)
        except ClimbOverflow as e:
            raise EngineFallback(str(e)) from e
    LAST_CLIMB_ENGINE = "device"
    with span("replay"):
        candidates = _replay_climb(peng, params, trace, selected, W)

        print(file=out)
        peng._status("Filtering degenerated IUPAC patterns")
        candidates = peng._filter_iupac_patterns(
            W, params.minimum_processed_motifs, candidates)
        for motif in candidates:
            print(f"selected iupac pattern: {motif.iupac_string()}",
                  file=out)

    # -- phases 3 + 4 head: PWMs + EM on the device, one fetch ------------
    peng._status("Calculating PWMs")
    # the reference prints and tags the *unclamped* max_k
    # (src/peng.cpp:397-399); tables are clamped to W-1
    background = peng.max_k
    with peng.timer.phase("pwm"):
        final_pwms = None
        if candidates:
            if params.adv_pwm:
                digit_mat = np.stack([
                    iupac_id_to_digits(m.pattern_id, W) for m in candidates])
                with span("adv"):
                    pwm0 = adv_pwm_program(
                        torch.from_numpy(digit_mat), st["counts"],
                        state.v[0], params.pseudo_counts, W, both, wide=wide)
            else:
                pwm0 = upload(np.stack(
                    [default_pwm(peng, params, m, W) for m in candidates]),
                    device)
            if params.use_em:
                final, _iters = em_optimize_flat(
                    pwm0, st["counts"], st["bg_max"],
                    params.em_saturation_factor, params.em_min_threshold,
                    params.em_max_iterations, W)
            with span("fetch"):
                if params.use_em:
                    final_pwms = sync_read(final).numpy()
                pwm0_np = sync_read(pwm0).numpy()
            for i, motif in enumerate(candidates):
                motif.pwm = np.array(pwm0_np[i], dtype=F32)
                motif.calculate_comp_pwm()
                peng._print_pwm_row(
                    "adv pwm: " if params.adv_pwm else "def pwm: ", motif)
    LAST_PWM_ENGINE = "device"

    peng._status("Optimizing expectation-maximization / merging patterns")
    print(f"\nbackground order: {background}", file=out)
    with peng.timer.phase("em+merge"):
        if params.use_em and candidates:
            optimized = []
            for i, motif in enumerate(candidates):
                new_motif = motif.clone_with_pwm(final_pwms[i])
                optimized.append(new_motif)
                info = numerics.pwm_info_content(new_motif.pwm) / W
                print(f"em: {motif.iupac_string()} -> "
                      f"{new_motif.pattern_string(peng.iupac_profile)}   "
                      f"[ avg. info: {info:.2f} ]", file=out)
        else:
            optimized = candidates
        if params.use_merging:
            if W >= MIN_MERGE_OVERLAP:
                with span("merge"):
                    peng._merge_patterns(
                        W, params.bit_factor_merge_threshold, optimized,
                        params.max_merged_length)
            else:
                print(f"Warning: Specified pattern length ({W}) is too "
                      "low for merging!", file=sys.stderr)

    for motif in optimized:
        motif.opt_bg_order = background
    LAST_ENGINE_USED = "gpu" if device.type == "cuda" else "cpu"
    return optimized
