"""Sharded counting: a data-parallel scan and one integer sum.

Counterpart of ``peng_motif_tpu/parallel/sharded.py`` (which replaces
the reference binary's single-process OpenMP loops,
src/base_pattern.cpp:289,331-441).  The corpus is cut into equal shards,
one per entry of a mesh (parallel/mesh.py: a tuple of ``torch.device``);
every shard is uploaded to its own device and counted there by the same
per-shard programs the single-device paths run — the 4**W table and the
fused background table built by the histogram kernel (ops/histogram.py)
— and the per-shard count table, ``ltot`` and background table are
summed onto ``mesh[0]``, the suspicion flags concatenated in shard
order.  Integer sums are exact in any order, so every result is
bit-identical to the single-device program's.

Where the reference's ``shard_map`` programs replicate the summed table
on every device (``out_specs=P()``), here it is resident on ``mesh[0]``
only: the table-local phases (stats, climb, PWM, EM) run on one device,
so the other replicas would be copies that nothing reads.

On CUDA the shards overlap as far as the one host thread that enqueues
them allows: launches are asynchronous and nothing in a shard's program
waits for its device, so device ``i + 1`` receives its shard while
device ``i`` counts, but each device starts only when the host has
enqueued the shards before it.  On four H100s (torch.profiler,
``python -m peng_motif_tpu_torch.bench_histogram mesh``) the four
kernel windows are staggered by the host's time to enqueue one shard
(16-20 us a launch: 5 ms a shard at 51.2 Mbases -w 10, 30 ms at 204.8
Mbases) against ~9 ms and ~34 ms of kernels a card, so the cards count
at the same time for part of the count only; the pageable upload is
0.4-1.8 ms of that stagger.  The functions do not ask whether the
mesh's entries are distinct; shards on one device simply run in turn.
Nothing is compiled per call, so there is no program cache (the
reference's ``lru_cache`` exists for XLA's re-jit).

The reference's ``_i32_shard_program`` (the uint16-overflow refetch) has
no counterpart: the port fetches the canonical slice as int32 from the
start.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..native import pack_codes_fused_native
from ..ops import encoding
from ..ops.counting import _apply_fixup_rows, _count_windows, _unpack_codes
from ..ops.histogram import histogram
from ..ops.stream_count import (
    _SLAB,
    _SLAB_MIN,
    StreamLayout,
    build_stream,
    chunked_packed,
    chunked_packed2,
    row_nbytes,
    row_nbytes2,
    stream_compact,
    stream_shard_counts,
    wire2_eligible,
)
from ..utils.logging_utils import span, sync_read, upload
from .mesh import Mesh


def _pad_batch(codes: np.ndarray, n_shards: int) -> np.ndarray:
    b = codes.shape[0]
    padded_b = ((b + n_shards - 1) // n_shards) * n_shards
    if padded_b == b:
        return codes
    out = np.zeros((padded_b,) + codes.shape[1:], dtype=codes.dtype)
    out[:b] = codes
    return out


def _upload(rows: np.ndarray, i: int, per: int, device) -> torch.Tensor:
    """Rows [i * per, (i + 1) * per) of a host array, on ``device``."""
    return upload(rows[i * per : (i + 1) * per], device)


def _sum_on_first(parts: List[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The per-shard tensors summed on ``mesh[0]`` (into the first)."""
    total = parts[0]
    for part in parts[1:]:
        total += part.to(mesh[0])
    return total


def _cat_on_first(parts: List[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    return torch.cat([part.to(mesh[0]) for part in parts])


# ---------------------------------------------------------------------------
# the stream count over a mesh (the device engine's count)
# ---------------------------------------------------------------------------


def shard_layout(lay: StreamLayout, n_shards: int):
    """(per, layout): chunks per shard, and ``lay`` with its chunk axis
    padded to ``per * n_shards``.  Shards above the slab threshold must
    align to the slab (ops/stream_count._accumulated_local_counts)."""
    per = -(-lay.m_pad // n_shards)
    if per > _SLAB_MIN:
        per = -(-per // _SLAB) * _SLAB
    return per, lay._replace(m_pad=per * n_shards)


def stream_counts_over_mesh(rows: np.ndarray, meta, row: int, ctx: int,
                            length: int, both_strands: bool, bg_order: int,
                            mesh: Mesh, per: int, base: int = 0):
    """Count ``len(mesh) * per`` packed chunk rows, shard ``i`` (rows
    [i * per, (i + 1) * per), global chunks from ``base + i * per``) on
    ``mesh[i]``: (counts [4**W] int32 un-mirrored, ltot int64, suspicious
    [len(mesh) * per] bool, bg or None), summed / concatenated on
    ``mesh[0]``.  ``meta`` picks the wire as in
    ops/stream_count.stream_shard_counts."""
    assert rows.shape[0] == len(mesh) * per, (rows.shape, len(mesh), per)
    parts = [stream_shard_counts(
        _upload(rows, i, per, dev), meta, row, ctx, length, both_strands,
        bg_order, base=base + i * per) for i, dev in enumerate(mesh)]
    counts, ltot, susp, bg = zip(*parts)
    return (_sum_on_first(list(counts), mesh),
            _sum_on_first(list(ltot), mesh),
            _cat_on_first(list(susp), mesh),
            _sum_on_first(list(bg), mesh) if bg_order >= 0 else None)


def stream_count_sharded(sequences, length: int, both_strands: bool,
                         mesh: Mesh, flat_codes: np.ndarray | None = None,
                         bg_order: int = -1, n_undefined=None):
    """Stream counting (ops/stream_count.py) with the chunks sharded over
    ``mesh``: each device scans its slice of the gap-packed stream — a
    single long contig shards with its exact 2(W-1)-window halo, because
    the rows are cut from the already chunked stream — and one integer
    sum gives the table.  ``bg_order >= 0`` also sums the fused
    background histogram.  Uniform N-free corpora take the 2-bit wire
    (each shard rebuilds validity from its global chunk offset).

    A mesh of one device is the single-device count: the layout is not
    padded and the one shard is the whole buffer.

    Returns (stream, layout, out): ``out`` is (mirrored counts resident
    on ``mesh[0]``, canonical vals, ltot, suspicious [m_pad], bg or
    None), before the host fix-up (ops/stream_count.stream_fixup_pairs);
    ``layout.m_pad`` is the padded global chunk axis that ``suspicious``
    indexes."""
    with span("stream"):
        stream, lay = build_stream(sequences, length, flat_codes=flat_codes)
        per, lay = shard_layout(lay, len(mesh))
        if n_undefined is None and flat_codes is not None:
            n_undefined = int(np.count_nonzero(flat_codes == 0))
        if n_undefined is not None and wire2_eligible(lay, n_undefined):
            rows = chunked_packed2(stream, lay).reshape(
                -1, row_nbytes2(lay.row))
            meta = (int(lay.lengths[0]), int(lay.stream_len))
        else:
            rows = chunked_packed(stream, lay).reshape(
                -1, row_nbytes(lay.row))
            meta = None
    with span("enqueue"):
        counts, ltot, susp, bg = stream_counts_over_mesh(
            rows, meta, lay.row, lay.ctx, length, both_strands, bg_order,
            mesh, per)
        counts, vals = stream_compact(counts, length, both_strands)
    return stream, lay, (counts, vals, ltot, susp, bg)


# ---------------------------------------------------------------------------
# the batch count over a mesh (the exact engine's count)
# ---------------------------------------------------------------------------


def _batch_counts_over_mesh(codes: np.ndarray, length: int,
                            both_strands: bool, mesh: Mesh):
    """The per-shard body of both batch counts: the packed rows of
    ``codes`` (padded to a multiple of the mesh) cut over ``mesh``, each
    shard counted by ops/counting._count_windows.  Returns (counts
    [4**W] int32 un-mirrored, ltot int64, suspicious [B_pad] bool) on
    ``mesh[0]``, and the padded host codes."""
    codes = _pad_batch(np.ascontiguousarray(codes, dtype=np.uint8),
                       len(mesh))
    seq_len = codes.shape[1]
    packed = pack_codes_fused_native(codes)
    per = codes.shape[0] // len(mesh)
    parts = [_count_windows(
        _unpack_codes(_upload(packed, i, per, dev), seq_len), length,
        both_strands) for i, dev in enumerate(mesh)]
    counts, ltot, susp = zip(*parts)
    return (_sum_on_first(list(counts), mesh),
            _sum_on_first(list(ltot), mesh),
            _cat_on_first(list(susp), mesh), codes)


def count_patterns_sharded(codes: np.ndarray, length: int,
                           both_strands: bool, mesh: Mesh):
    """Count patterns with the sequences sharded across ``mesh``.

    Same transfer-minimal design as the single-device CountJob
    (ops/counting.py): the packed 2-bit buffer shards over the mesh, each
    shard counts its sequences with the vectorized exact dedup and its
    suspicion certificate, the per-shard tables are summed, and only the
    canonical slice leaves the device; the reverse-complement mirror and
    the (rare) suspicious-row fix-up run on host, reproducing the serial
    table bit for bit.

    Returns (counts_np int32 [4**W] host table, ltot int).
    """
    from ..native import mirror_canonical_native  # noqa: PLC0415

    if codes.shape[0] == 0 or codes.shape[1] < length:
        # no window fits: the reference scan finds nothing
        return np.zeros(4 ** length, dtype=np.int32), 0
    counts, ltot, susp, codes = _batch_counts_over_mesh(
        codes, length, both_strands, mesh)
    if both_strands:
        vals = counts[encoding.canonical_idx_flat(length, counts.device)]
        counts_np = mirror_canonical_native(sync_read(vals).numpy(), length)
    else:
        counts_np = sync_read(counts).numpy()
    susp_np = sync_read(susp).numpy()
    if susp_np.any():
        counts64 = counts_np.astype(np.int64)
        _apply_fixup_rows(counts64, codes[np.flatnonzero(susp_np)], length,
                          both_strands)
        counts_np = counts64.astype(np.int32)
    return counts_np, sync_read(ltot, int)


def count_device_full_sharded(codes: np.ndarray, length: int,
                              both_strands: bool, mesh: Mesh):
    """:func:`count_patterns_sharded` with the table kept on the device:
    (mirrored counts [4**W] int32 resident on ``mesh[0]``, canonical
    vals int32, ltot int64, suspicious [B_pad] bool, codes_padded) —
    ``suspicious`` indexes the padded host batch, whose rows the caller
    fixes up."""
    counts, ltot, susp, codes = _batch_counts_over_mesh(
        codes, length, both_strands, mesh)
    counts, vals = stream_compact(counts, length, both_strands)
    return counts, vals, ltot, susp, codes


# ---------------------------------------------------------------------------
# background (k+1)-mer counts over a mesh
# ---------------------------------------------------------------------------


def count_bg_kmers_sharded(codes: np.ndarray, order: int, mesh: Mesh,
                           lengths: np.ndarray) -> List[np.ndarray]:
    """Sharded (k+1)-mer counting for the background model: per-shard
    count vectors (each a histogram-kernel call) and one sum; the native
    host scan (models/background.count_kmers) is the semantics oracle.

    ``lengths`` (required) gives the true per-row sequence lengths: the
    reference counts every in-sequence window including trailing-N ones
    at y == 0 (src/shared/BackgroundModel.cpp counting loop, i < L), so
    the extent cannot be inferred from the codes (trailing Ns encode as
    0, same as padding).  Returns one int64 vector [4**(k+1)] per order
    k = 0..order."""
    codes = _pad_batch(np.ascontiguousarray(codes, dtype=np.uint8),
                       len(mesh))
    lens = np.zeros(codes.shape[0], dtype=np.int32)
    lens[: len(lengths)] = np.asarray(lengths)
    per = codes.shape[0] // len(mesh)
    parts = []
    for i, dev in enumerate(mesh):
        shard_codes = _upload(codes, i, per, dev)
        shard_lens = _upload(lens, i, per, dev)
        in_seq = (torch.arange(shard_codes.shape[1], device=dev)[None, :]
                  < shard_lens[:, None])
        tabs = []
        for k in range(order + 1):
            y, ok = _bg_window_values(shard_codes, k)
            ok &= in_seq
            # values of uncounted windows are never read by the histogram
            tabs.append(histogram(y.reshape(-1), ok.reshape(-1),
                                  4 ** (k + 1)))
        parts.append(tabs)
    return [sync_read(_sum_on_first([tabs[k] for tabs in parts], mesh))
            .numpy().astype(np.int64) for k in range(order + 1)]


def _bg_window_values(codes: torch.Tensor, k: int):
    """Device version of the background (k+1)-mer window rule including
    the reference N-quirk (see models/background.py): (value [B, L]
    int32, ok [B, L] bool) for the window ending at each position.
    Padding zeros count as Ns, and positions beyond each sequence end
    would contribute v == 0 windows — the caller must mask ``ok`` down
    to each row's true extent."""
    codes = codes.to(torch.int32)
    b, length = codes.shape
    dev = codes.device
    is_n = (codes == 0).to(torch.int32)
    csum = torch.cat([torch.zeros((b, 1), dtype=torch.int32, device=dev),
                      torch.cumsum(is_n, dim=1, dtype=torch.int32)], dim=1)
    idx = torch.arange(length, device=dev)
    lo = (idx - 8).clamp_min(0)
    any_n9 = (csum[:, idx + 1] - csum[:, lo]) > 0
    nonneg = (codes - 1).clamp_min(0)
    v = torch.zeros_like(codes)
    for j in range(min(k + 1, length)):
        v[:, j:] += nonneg[:, : length - j] * (4 ** j)
    ok = (idx >= k)[None, :] & (~any_n9 | (v == 0))
    return v, ok
