"""Stream counting: gap-packed corpus, fixed-width halo chunks.

The reference scans one logical stream: sequences back to back, with a
W-position bookkeeping gap between them so the non-overlap rule never
crosses a boundary (reference: src/base_pattern.cpp:331-393, gap rule
at :382).  This module makes that stream the device layout:

    stream  = seq_0 ++ 0^W ++ seq_1 ++ 0^W ++ ... ++ seq_{n-1}
    chunk c = stream[c*C - ctx : c*C + C + W - 1]     (left zero-pad)

Every stream window start s belongs to exactly one chunk (c = s // C,
the chunk's *core*); the first ``ctx = 2(W-1)`` windows of each chunk
are context only — they reproduce the true left neighborhood so the
core's validity / post-N-skip / non-overlap decisions match the
unchunked scan, but produce no counts.  The W zeros of an inter-sequence
gap make every boundary-spanning window invalid and keep both the
blocking rule and the post-N skip rule from leaking across sequences.

Exactness: within a chunk the decisions are computed from true stream
bases, so they equal the unchunked decisions except in two certified-
rare cases, both flagged per chunk and repaired by the host fix-up
(:func:`stream_fixup_pairs`):

1. dedup suspicion — same-pattern chains with gaps < W
   (``counting.naive_dedup``'s certificate);
2. seam ambiguity — a post-N-skip parity chain (an N every W+1 bases)
   reaching the chunk's left edge (see ``_skip_and_ambiguity``).

Host parts (layout, packing, fix-up) are numpy and native code shared
in form with the reference package; the device parts are torch code on
the caller's device, with both count tables built by the histogram
kernel (ops/histogram.py).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from . import encoding
from .counting import (_np_revcomp_id, _post_n_chains, _row_cids_processed,
                       _unpack_codes, naive_dedup)
from .histogram import histogram

ROW = 512  # fixed chunk width in bases


class StreamLayout(NamedTuple):
    W: int
    row: int            # chunk width in bases (ROW)
    ctx: int            # context windows per chunk = 2(W-1)
    core: int           # core windows per chunk C = row - W + 1 - ctx
    n_windows: int      # stream window count S - W + 1 (>= 0)
    stream_len: int     # S
    m: int              # number of real chunks
    m_pad: int          # padded chunk count (shape bucket)
    seq_starts: np.ndarray  # [n] stream offset of each sequence
    lengths: np.ndarray     # [n] sequence lengths


def _bucket(m: int) -> int:
    """Chunk-count ladder: powers of two up to 8192, then multiples of
    4096, then multiples of the slab size (counts above _SLAB_MIN chunks
    run in _SLAB-chunk slabs, see _accumulated_local_counts; padding
    chunks are all-zero and fully invalid)."""
    if m <= 0:
        return 1
    if m <= 8192:
        return 1 << (m - 1).bit_length()
    if m <= 65536:
        return ((m + 4095) // 4096) * 4096
    return ((m + 16383) // 16384) * 16384


def make_layout(lengths: Sequence[int], W: int, row: int = ROW
                ) -> StreamLayout:
    lengths = np.asarray(lengths, dtype=np.int64)
    ctx = 2 * (W - 1)
    core = row - W + 1 - ctx
    assert core > 0, "row too small for this W"
    n = lengths.shape[0]
    gaps = W * max(n - 1, 0)
    # W-1 trailing zeros: every *position* of the stream (not just every
    # W-window start) then lies in exactly one chunk core, so the fused
    # background (k+1)-mer histogram covers the tail of the last
    # sequence.  The extra windows contain zeros and are invalid, so
    # W-mer counts and ltot are unchanged.
    S = int(lengths.sum()) + gaps + (W - 1 if n else 0)
    seq_starts = np.zeros(n, dtype=np.int64)
    if n:
        seq_starts[1:] = np.cumsum(lengths[:-1] + W)
    n_win = max(S - W + 1, 0)
    m = max(-(-n_win // core), 1)
    return StreamLayout(W, row, ctx, core, n_win, S, m, _bucket(m),
                        seq_starts, lengths)


def build_stream(sequences: Sequence[np.ndarray], W: int,
                 flat_codes: np.ndarray | None = None,
                 row: int = ROW) -> tuple[np.ndarray, StreamLayout]:
    """Concatenate sequences with W-zero gaps: a threaded native fill
    from ``flat_codes`` (the contiguous parse buffer) when it matches,
    else a per-sequence slice copy."""
    lengths = np.asarray([len(s) for s in sequences], dtype=np.int64)
    lay = make_layout(lengths, W, row)
    stream = np.zeros(lay.stream_len, dtype=np.uint8)
    if flat_codes is not None and flat_codes.shape[0] == int(lengths.sum()):
        from ..native import build_stream_fill_native  # noqa: PLC0415

        build_stream_fill_native(flat_codes, lengths, W, stream)
        return stream, lay
    for st, s in zip(lay.seq_starts, sequences):
        stream[st : st + len(s)] = np.asarray(s, dtype=np.uint8)
    return stream, lay


def chunked_packed(stream: np.ndarray, lay: StreamLayout) -> np.ndarray:
    """Flat packed chunk buffer [m_pad * row_nbytes(row)] uint8 (native
    fused chunk + pack; equals ``pack_codes(chunk_rows(...))``)."""
    from ..native import chunk_pack_stream_native  # noqa: PLC0415

    return chunk_pack_stream_native(
        stream, lay.m_pad, lay.row, lay.core, lay.ctx)


def chunk_rows(stream: np.ndarray, lay: StreamLayout) -> np.ndarray:
    """[m_pad, row] uint8 chunk matrix (left context + core + W-1 tail);
    rows past ``m`` are all-zero padding (fully invalid)."""
    need = lay.ctx + (lay.m_pad - 1) * lay.core + lay.row
    padded = np.zeros(need, dtype=np.uint8)
    padded[lay.ctx : lay.ctx + lay.stream_len] = stream
    view = np.lib.stride_tricks.as_strided(
        padded, shape=(lay.m_pad, lay.row),
        strides=(lay.core * padded.strides[0], padded.strides[0]))
    return np.ascontiguousarray(view)


def row_nbytes(row: int) -> int:
    """Packed bytes per chunk row (2-bit codes + 1-bit N mask)."""
    return (row + 3) // 4 + (row + 7) // 8


# ---------------------------------------------------------------------------
# wire2: 2-bit-only transfer format
#
# For the common case — no undefined bases, uniform sequence lengths
# (ChIP-seq peak sets, the bench corpora) — the 1-bit N-mask third of the
# wire bytes is redundant: every invalid position (inter-sequence gap
# zeros, chunk-0 left padding, stream tail, bucket padding chunks) is
# arithmetically derivable from (seq_len, stream_len), because seq k
# starts at k * (seq_len + W).  The device reconstructs codes == 0
# exactly, so all downstream decision logic is unchanged.
# ---------------------------------------------------------------------------


def row_nbytes2(row: int) -> int:
    """Packed bytes per chunk row on the 2-bit wire."""
    return (row + 3) // 4


def wire2_eligible(lay: StreamLayout, n_undefined) -> bool:
    """2-bit wire: no Ns, uniform lengths, int32-safe positions."""
    return (n_undefined == 0
            and lay.lengths.size > 0
            and int(lay.lengths.min()) == int(lay.lengths.max())
            and lay.stream_len < (1 << 31) - (1 << 16))


def chunked_packed2(stream: np.ndarray, lay: StreamLayout) -> np.ndarray:
    """Flat 2-bit packed chunk buffer [m_pad * row_nbytes2(row)] uint8
    (native threaded pass).  Gap/padding positions pack as garbage 2-bit
    values — the device masks them via the arithmetic validity rule."""
    from ..native import chunk_pack_stream2_native  # noqa: PLC0415

    return chunk_pack_stream2_native(
        stream, lay.m_pad, lay.row, lay.core, lay.ctx)


# ---------------------------------------------------------------------------
# device program
# ---------------------------------------------------------------------------


def _skip_and_ambiguity(codes: torch.Tensor, valid: torch.Tensor,
                        length: int):
    """Chunked post-N-skip mask (``counting.scan_skip_mask`` on the chunk
    rows) plus the per-row seam-ambiguity flag.

    A row is *ambiguous* when any stride-(W+1) chain's first in-row
    evaluable element (x in [d, 2d)) may have a == 1: its run may extend
    into the previous chunk, so the zero-padded parity may be wrong.
    Rows where every such element has a == 0 are provably exact.
    """
    n_win = valid.shape[1]
    d = length + 1
    b = valid.shape[0]
    dev = codes.device
    if n_win <= d:
        return torch.zeros_like(valid), torch.zeros(b, dtype=torch.bool,
                                                    device=dev)
    skip, a_p = _post_n_chains(codes, valid, length)
    if a_p.shape[1] > 1:
        # a chain's zero-padded head can misstate the run parity only if
        # its element-0 value a[r] = isN(r-1) & valid(r-d) could be 1:
        # for r >= 1 the isN(r-1) factor is in-row, so a clean base
        # there proves a[r] == 0 and bounds the run
        head_unbounded = torch.cat(
            [torch.ones((b, 1), dtype=torch.bool, device=dev),
             codes[:, : d - 1] == 0], dim=1)
        ambiguous = (a_p[:, 1, :] & head_unbounded).any(dim=1)
    else:
        ambiguous = torch.zeros(b, dtype=torch.bool, device=dev)
    return skip, ambiguous


def bg_nbins(bg_order: int) -> int:
    """Combined (lane-aligned) bin count of the fused background
    histogram: orders 0..bg_order concatenated at offsets
    ``bg_offset(k)``, padded to a multiple of 128."""
    raw = sum(4 ** (k + 1) for k in range(bg_order + 1))
    return -(-raw // 128) * 128


def bg_offset(k: int) -> int:
    return sum(4 ** (j + 1) for j in range(k))


def stream_bg_counts(codes: torch.Tensor, ctx: int, core: int,
                     bg_order: int, out=None) -> torch.Tensor:
    """Fused background (k+1)-mer histogram over the chunk batch.

    Device rule (see models/background.bg_device_corrections for the
    host-side completion): a window *ending* at core position q counts
    for every order k iff the 9 stream positions q-8..q are all defined
    (non-zero) — the reference's fixed 9-position N-lookback
    (src/shared/Sequence.cpp:28-33, BackgroundModel.cpp:73-81) evaluated
    over the gap-packed stream, where inter-sequence gap zeros and the
    chunk-0 left padding read as Ns.  Requires ctx >= 8.

    Returns one int32 vector of length :func:`bg_nbins` holding the
    order-k counts at offset :func:`bg_offset`; with ``out`` given the
    counts are added into it.
    """
    assert ctx >= 8, "bg lookback needs 8 context positions"
    b, row = codes.shape
    dev = codes.device
    pos = codes > 0
    clean = pos.clone()
    for j in range(1, 9):
        clean[:, j:] &= pos[:, :-j]
    clean[:, :8] = False
    q = torch.arange(row, device=dev)
    core_pos = (q >= ctx) & (q < ctx + core)
    counted = clean & core_pos[None, :]
    nonneg = (codes.to(torch.int32) - 1).clamp_min(0)
    ids_k = []
    vk = nonneg
    for k in range(bg_order + 1):
        if k > 0:
            shifted = torch.zeros_like(nonneg)
            shifted[:, k:] = nonneg[:, :-k]
            vk = vk + shifted * (4 ** k)
        ids_k.append(vk + bg_offset(k))
    flat_ids = torch.stack(ids_k).reshape(-1)
    flat_inc = counted.expand(bg_order + 1, b, row).reshape(-1)
    return histogram(flat_ids, flat_inc, bg_nbins(bg_order), out=out)


def stream_local_counts(codes: torch.Tensor, ctx: int, length: int,
                        both_strands: bool, bg_order: int = -1,
                        counts_out=None, bg_out=None):
    """Per-chunk-batch raw counting: (counts [4**W] int32 un-mirrored,
    ltot int64, suspicious [rows] bool, bg) — ``bg`` is the fused
    background histogram (:func:`stream_bg_counts`) when
    ``bg_order >= 0``, else None.  ``counts_out`` / ``bg_out``: running
    tables that the two histograms add into (and that are returned)."""
    fwd, rc, valid = encoding.window_ids(codes, length)
    skip, ambiguous = _skip_and_ambiguity(codes, valid, length)
    processed = valid & ~skip
    core_win = torch.arange(valid.shape[1], device=codes.device) >= ctx
    cids = torch.where(processed, torch.minimum(fwd, rc) if both_strands
                       else fwd, -1)
    counted, susp = naive_dedup(cids, length)
    counted &= core_win[None, :]
    # ids of uncounted windows are never read by the histogram
    counts = histogram(cids.reshape(-1), counted.reshape(-1), 4 ** length,
                       out=counts_out)
    ltot = (processed & core_win[None, :]).sum(dtype=torch.int64)
    bg = None
    if bg_order >= 0:
        core = codes.shape[1] - length + 1 - ctx
        bg = stream_bg_counts(codes, ctx, core, bg_order, out=bg_out)
    return counts, ltot, susp | ambiguous, bg


def stream_compact(counts: torch.Tensor, length: int, both_strands: bool):
    """(mirrored counts [4**W], canonical slice int32) — the slice is
    what the host fetches; the mirror step is the reference's
    src/base_pattern.cpp:386-392."""
    if not both_strands:
        return counts, counts
    dev = counts.device
    vals = counts[encoding.canonical_idx_flat(length, dev)]
    counts = torch.where(encoding.canonical_mask_flat(length, dev), counts,
                         counts[encoding.rc_ids_flat(length, dev)])
    return counts, vals


def _unpack_codes2(buf2d: torch.Tensor, row: int, g0: int, core: int,
                   ctx: int, length: int, seq_len: int, stream_len: int):
    """Codes (0 = invalid, 1..4 = ACGT) from the 2-bit wire.

    ``g0``: global chunk index of row 0.  Validity: stream position
    p = (g0 + i) * core - ctx + j is a real base iff 0 <= p < stream_len
    and p mod (seq_len + W) < seq_len (sequence k occupies
    [k * (seq_len + W), ... + seq_len)).
    """
    b = buf2d.shape[0]
    dev = buf2d.device
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=dev)
    vals = ((buf2d[:, :, None] >> shifts) & 3).reshape(b, -1)[:, :row]
    i = torch.arange(b, dtype=torch.int64, device=dev)[:, None]
    j = torch.arange(row, dtype=torch.int64, device=dev)[None, :]
    p = (g0 + i) * core - ctx + j
    r = p.clamp_min(0) % (seq_len + length)
    valid = (p >= 0) & (p < stream_len) & (r < seq_len)
    return torch.where(valid, vals.to(torch.int32) + 1, 0)


# chunk-axis slab: above _SLAB_MIN chunks the count runs over fixed
# _SLAB-chunk slabs, so peak device memory is one slab's intermediates
# (unpacked codes + window ids + masks are ~40 bytes/base)
_SLAB = 16384
_SLAB_MIN = 65536


def _accumulated_local_counts(buf2d: torch.Tensor, row: int, ctx: int,
                              length: int, both_strands: bool,
                              bg_order: int = -1, codes_fn=None):
    """(counts [4**W] int32 un-mirrored, ltot int64, susp [m_pad], bg):
    single pass for small chunk counts, a loop over slabs otherwise.
    ``codes_fn(slab_buf, first_chunk_idx) -> codes`` decodes the wire
    format (default: the 2-bit + N-mask unpack)."""
    if codes_fn is None:
        def codes_fn(sl, g0):
            return _unpack_codes(sl, row)
    m_pad = buf2d.shape[0]
    slab, slab_min = _SLAB, _SLAB_MIN
    if m_pad <= slab_min:
        return stream_local_counts(codes_fn(buf2d, 0), ctx, length,
                                   both_strands, bg_order)
    assert m_pad % slab == 0, "bucket ladder must align to _SLAB"
    counts = ltot = bg = None
    susp = torch.zeros(m_pad, dtype=torch.bool, device=buf2d.device)
    for k0 in range(0, m_pad, slab):
        # from the second slab on, both histograms add into the running
        # tables: no table is allocated, zeroed or summed per slab
        counts, lt, sp, bg = stream_local_counts(
            codes_fn(buf2d[k0 : k0 + slab], k0), ctx, length, both_strands,
            bg_order, counts_out=counts, bg_out=bg)
        susp[k0 : k0 + slab] = sp
        ltot = lt if ltot is None else ltot + lt
    return counts, ltot, susp, bg


def stream_shard_counts(buf: torch.Tensor, meta, row: int, ctx: int,
                        length: int, both_strands: bool, bg_order: int = -1,
                        base: int = 0):
    """The count of one run of chunk rows, on ``buf``'s device, before
    the mirror: (counts [4**W] int32 un-mirrored, ltot int64, suspicious
    [rows] bool, bg int32 [bg_nbins] or None).  Per-shard tables of one
    corpus add up to the whole corpus's.

    ``meta`` picks the wire: None for the 3-bit wire (2-bit codes + N
    mask), (seq_len, stream_len) for the 2-bit wire, whose validity rule
    needs global stream positions: ``base`` is the global chunk index of
    row 0 (0 for a whole corpus, ``i * per`` for shard ``i`` of a mesh).
    Nothing here waits for the device."""
    if meta is None:
        return _accumulated_local_counts(
            buf.view(-1, row_nbytes(row)), row, ctx, length, both_strands,
            bg_order)
    seq_len, stream_len = int(meta[0]), int(meta[1])
    core = row - length + 1 - ctx

    def codes_fn(sl, g0):
        return _unpack_codes2(sl, row, base + g0, core, ctx, length, seq_len,
                              stream_len)

    return _accumulated_local_counts(
        buf.view(-1, row_nbytes2(row)), row, ctx, length, both_strands,
        bg_order, codes_fn=codes_fn)


# ---------------------------------------------------------------------------
# host twin + fix-up
# ---------------------------------------------------------------------------


def _np_window_ids(row: np.ndarray, W: int, both: bool):
    """(cid, valid) numpy twin of window_ids + canonicalization."""
    c = row.astype(np.int64)
    n_win = c.shape[0] - W + 1
    valid = np.ones(n_win, dtype=bool)
    fwd = np.zeros(n_win, dtype=np.int64)
    rcv = np.zeros(n_win, dtype=np.int64)
    for p in range(W):
        cc = c[p : p + n_win]
        valid &= cc > 0
        fwd += (cc - 1) * (4 ** p)
        rcv += (4 - cc) * (4 ** (W - 1 - p))
    cid = np.minimum(fwd, rcv) if both else fwd
    return np.where(valid, cid, -1), valid


def _np_chunk_decisions(row: np.ndarray, ctx: int, W: int, both: bool):
    """Numpy twin of the device's per-chunk decision: returns (counted
    mask over core windows, cid per window) exactly as the device
    computes them (including the zero-padded skip-chain heads)."""
    d = W + 1
    cid, valid = _np_window_ids(row, W, both)
    n_win = valid.shape[0]
    is_n = row == 0
    skip = np.zeros(n_win, dtype=bool)
    for s in range(d, n_win):
        a = is_n[s - 1] and valid[s - d]
        skip[s] = a and not skip[s - d]
    processed = valid & ~skip
    cids = np.where(processed, cid, -1)
    blocked = np.zeros(n_win, dtype=bool)
    for dd in range(1, min(W, n_win)):
        eq = (cids[dd:] == cids[:-dd]) & (cids[dd:] >= 0) & (cids[:-dd] >= 0)
        blocked[dd:] |= eq
    counted = (cids >= 0) & ~blocked
    counted[:ctx] = False
    return counted, cids


def _np_exact_row(row: np.ndarray, W: int, both: bool):
    """Exact greedy counted mask for one fresh sequence, via the
    processed-window semantics (reference scan automaton,
    src/base_pattern.cpp:331-393)."""
    cid = _row_cids_processed(row, W, both)
    n_win = cid.shape[0]
    counted = np.zeros(n_win, dtype=bool)
    last: dict = {}
    for j in range(n_win):
        i = int(cid[j])
        if i < 0:
            continue
        if i not in last or j - last[i] >= W:
            counted[j] = True
            last[i] = j
    return counted, cid


def stream_fixup_delta(stream: np.ndarray, lay: StreamLayout,
                       susp: np.ndarray, both: bool):
    """(delta, ltot_delta): sparse {canonical_id: count delta} plus the
    processed-window (ltot) correction, turning the device's chunked
    decisions into the exact scan for every sequence touched by a
    suspicious chunk.  Python twin and test oracle of the native
    ``stream_fixup_native``."""
    W, C, ctx = lay.W, lay.core, lay.ctx
    susp_chunks = np.flatnonzero(susp[: lay.m])
    if susp_chunks.size == 0 or lay.seq_starts.size == 0:
        return {}, 0
    seq_starts = lay.seq_starts
    seq_ends = seq_starts + lay.lengths

    # sequences overlapping a suspicious chunk's influence region
    affected: set = set()
    for c in susp_chunks:
        lo = c * C - ctx
        hi = c * C + C + W - 1
        i0 = np.searchsorted(seq_ends, lo, side="right")
        i1 = np.searchsorted(seq_starts, hi, side="left")
        affected.update(range(int(i0), int(i1)))

    # replicate device decisions for every chunk overlapping an
    # affected sequence
    chunk_cache: dict = {}

    def chunk_decisions(c: int):
        if c not in chunk_cache:
            lo = c * C - ctx
            row = np.zeros(lay.row, dtype=np.uint8)
            s0, s1 = max(lo, 0), min(lo + lay.row, lay.stream_len)
            if s1 > s0:
                row[s0 - lo : s1 - lo] = stream[s0:s1]
            chunk_cache[c] = _np_chunk_decisions(row, ctx, W, both)
        return chunk_cache[c]

    delta: dict = {}
    ltot_delta = 0
    for k in sorted(affected):
        st, ln = int(seq_starts[k]), int(lay.lengths[k])
        if ln < W:
            continue
        seq = stream[st : st + ln]
        exact_counted, cid = _np_exact_row(seq, W, both)
        for j in range(ln - W + 1):
            s = st + j                      # stream window start
            c = s // C
            local = s - c * C + ctx
            dev_counted, dev_cid = chunk_decisions(c)
            dv = int(exact_counted[j]) - int(dev_counted[local])
            if dv:
                delta_id = int(cid[j]) if cid[j] >= 0 else int(
                    dev_cid[local])
                delta[delta_id] = delta.get(delta_id, 0) + dv
            ltot_delta += int(cid[j] >= 0) - int(dev_cid[local] >= 0)
    return {k: v for k, v in delta.items() if v}, ltot_delta


def stream_fixup_pairs(stream: np.ndarray, lay: StreamLayout,
                       susp: np.ndarray, both: bool,
                       pad_to: int = 1024):
    """(ids, deltas, ltot_delta) with reverse-complement mirror ids
    included, zero-padded to at least ``pad_to`` entries (the shape the
    reference's device scatter takes).  Native
    (pengnative.cpp stream_fixup_native); :func:`stream_fixup_delta` is
    its Python twin."""
    from ..native import stream_fixup_delta_native  # noqa: PLC0415

    susp_chunks = np.flatnonzero(np.asarray(susp[: lay.m]))
    delta: dict = {}
    ltot_delta = 0
    if susp_chunks.size and lay.seq_starts.size:
        ids_arr, dv_arr, ltot_delta = stream_fixup_delta_native(
            stream, lay.seq_starts, lay.lengths, susp_chunks,
            lay.W, lay.row, lay.core, lay.ctx, both)
        delta = dict(zip(ids_arr.tolist(), dv_arr.tolist()))
    ids, dvs = [], []
    for cid, dv in delta.items():
        ids.append(cid)
        dvs.append(dv)
        if both:
            rcid = _np_revcomp_id(cid, lay.W)
            if rcid != cid:
                ids.append(rcid)
                dvs.append(dv)
    n = max(pad_to, 1 << (len(ids) - 1).bit_length()) if ids else pad_to
    out_ids = np.zeros(n, dtype=np.int32)
    out_dv = np.zeros(n, dtype=np.int32)
    out_ids[: len(ids)] = ids
    out_dv[: len(dvs)] = dvs
    return out_ids, out_dv, ltot_delta
