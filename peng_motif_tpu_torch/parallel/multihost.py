"""Multi-process distribution of the count.

Counterpart of ``peng_motif_tpu/parallel/multihost.py`` (which lifts the
reference binary's single-process OpenMP ceiling, src/main.cpp:28-30) on
``torch.distributed``: N processes, each driving a local mesh of its own
devices, form one global mesh of shards.  The gap-packed chunk stream
(ops/stream_count.py) shards across all of them, every process counts
its block on its local mesh (parallel/sharded.py), and the per-process
tables are summed with one integer all-reduce; the background (k+1)-mer
vectors are summed the same way.  Counting is the only corpus-wide
phase, so these collectives are the entire cross-process communication
surface; the table-local phases then run in process 0 only.

Every process needs the global stream layout, which depends on all
sequence lengths; the *scans* are what shard.  Process 0 parses the
whole input and writes all output; the other processes read lengths
only, decode just the sequences their block touches, join the
collectives and exit.

The collectives' transport is chosen from facts, by
:func:`choose_backend`: NCCL when the count runs on CUDA and every
process owns its cards alone; gloo on the CPU, and on CUDA when two
processes share a card (NCCL refuses two ranks on one GPU).  With gloo
the collectives run on host copies of the tables — exactly the arrays
process 0 fetches to the host right after them, so nothing the device
needs later is moved.  The count itself runs on the local mesh in both
cases: the choice of transport never moves the kernel to the CPU.
``LAST_BACKEND`` says which transport the last :func:`init_multihost`
chose.
"""

from __future__ import annotations

import datetime
import os
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..io.fasta import read_fasta_ranges
from ..models.background import count_kmers
from ..native import pack_codes_fused_native
from ..ops import histogram as hist
from ..ops.stream_count import (
    build_stream,
    chunk_rows,
    make_layout,
    stream_compact,
    stream_fixup_pairs,
)
from ..utils.logging_utils import get_logger, sync_read, upload
from .mesh import Mesh, make_data_mesh
from .sharded import shard_layout, stream_counts_over_mesh

# the transport of the last init_multihost: "nccl" or "gloo"
LAST_BACKEND = None


class MultihostContext(NamedTuple):
    """What :func:`init_multihost` set up, handed to the counts."""

    rank: int
    world: int
    mesh: Mesh                  # this process's local mesh
    shards: tuple               # local mesh size of every process, by rank
    backend: str                # "nccl" or "gloo"
    group: object               # the NCCL group, or None (the gloo group)
    device: torch.device        # where collective operands live


def choose_backend(device_type: str, cards_by_rank: Sequence[Sequence[str]]
                   ) -> str:
    """"nccl" when the count runs on CUDA and no card (by UUID) is driven
    by two processes, else "gloo"."""
    if device_type != "cuda":
        return "gloo"
    cards = [c for rank_cards in cards_by_rank for c in rank_cards]
    return "nccl" if len(set(cards)) == len(cards) else "gloo"


def card_sets(n_cards: int, num_processes: int) -> List[str]:
    """What a launcher sets as ``CUDA_VISIBLE_DEVICES`` for each of
    ``num_processes`` processes on a machine with ``n_cards`` cards, so
    that every process owns cards of its own: consecutive blocks of
    ``n_cards // num_processes`` cards ("0", "1", ... with one card a
    process; "0,1", "2,3" with two).  A process started without it sees
    every card, and its default mesh is all of them: the processes then
    share cards, and :func:`choose_backend` answers gloo."""
    if not 1 <= num_processes <= n_cards:
        raise ValueError(
            f"{num_processes} processes cannot own cards of their own "
            f"among {n_cards}")
    per = n_cards // num_processes
    return [",".join(str(c) for c in range(p * per, (p + 1) * per))
            for p in range(num_processes)]


def _card_ids(mesh: Mesh) -> List[str]:
    return [str(torch.cuda.get_device_properties(d).uuid)
            for d in mesh if d.type == "cuda"]


def init_multihost(coordinator: str, num_processes: int, process_id: int,
                   timeout_s: int | None = None, device="cuda",
                   mesh: Optional[Mesh] = None) -> MultihostContext:
    """Join the process group at ``tcp://coordinator`` and agree on the
    global mesh.

    ``timeout_s`` (default 300, env PENG_MULTIHOST_TIMEOUT) bounds the
    rendezvous and every collective: a process that never shows up, or
    drops out mid-run, fails every peer with an error inside the bound
    instead of an indefinite hang.

    ``mesh``: this process's local mesh; by default every card the
    process sees on ``cuda``, one shard on ``cpu``.  The processes first
    meet over gloo and exchange their local mesh sizes and card UUIDs;
    :func:`choose_backend` then picks the transport of the table
    collectives, and for NCCL a second group is made.
    """
    global LAST_BACKEND
    if timeout_s is None:
        timeout_s = int(os.environ.get("PENG_MULTIHOST_TIMEOUT", "300"))
    timeout = datetime.timedelta(seconds=timeout_s)
    if mesh is None:
        mesh = make_data_mesh(None, device)
    dist.init_process_group(
        backend="gloo", init_method=f"tcp://{coordinator}",
        rank=process_id, world_size=num_processes, timeout=timeout)
    try:
        facts = [None] * num_processes
        dist.all_gather_object(facts, (len(mesh), _card_ids(mesh)))
        backend = choose_backend(mesh[0].type, [f[1] for f in facts])
        group = None
        if backend == "nccl":
            torch.cuda.set_device(mesh[0])
            group = dist.new_group(backend="nccl", timeout=timeout)
    except BaseException:
        dist.destroy_process_group()
        raise
    LAST_BACKEND = backend
    return MultihostContext(
        rank=process_id, world=num_processes, mesh=mesh,
        shards=tuple(f[0] for f in facts), backend=backend, group=group,
        device=mesh[0] if backend == "nccl" else torch.device("cpu"))


def shutdown_multihost() -> None:
    """Leave the process groups :func:`init_multihost` joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _move(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``, a copy to or from the host counted as the
    recorder's helpers count it."""
    if t.device.type != "cpu" and device.type == "cpu":
        return sync_read(t)
    return upload(t, device)


def _all_reduce_sum(ctx: MultihostContext, t: torch.Tensor) -> torch.Tensor:
    """Sum of ``t`` over the processes, on ``ctx.device`` (1-D)."""
    t = _move(t, ctx.device).reshape(-1).contiguous()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=ctx.group)
    return t


def _all_gather_blocks(ctx: MultihostContext, t: torch.Tensor, per: int
                       ) -> torch.Tensor:
    """The processes' uint8 blocks (``shards[r] * per`` entries each)
    concatenated in rank order, on ``ctx.device``.  Blocks are padded to
    the largest, since a gather takes equal sizes."""
    widest = max(ctx.shards) * per
    mine = torch.zeros(widest, dtype=torch.uint8, device=ctx.device)
    mine[: t.numel()] = _move(t, ctx.device)
    blocks = [torch.empty_like(mine) for _ in range(ctx.world)]
    dist.all_gather(blocks, mine, group=ctx.group)
    return torch.cat([b[: n * per] for b, n in zip(blocks, ctx.shards)])


def _local_block(ctx: MultihostContext, per: int):
    """Contiguous [lo, hi) chunk-row range owned by this process's
    shards of the global mesh."""
    first = sum(ctx.shards[: ctx.rank])
    return first * per, (first + ctx.shards[ctx.rank]) * per


def _stream_segment_rows(input_path: str, lay, lo: int, hi: int
                         ) -> np.ndarray:
    """Chunk rows [lo, hi) built from only the sequences overlapping
    this process's stream span — the worker-process path that avoids
    parsing (and holding) the whole corpus.  Decodes via
    io.fasta.read_fasta_ranges (identical encoding LUT to the full
    parse)."""
    core, ctx, row = lay.core, lay.ctx, lay.row
    span_lo = lo * core - ctx
    span_hi = (hi - 1) * core - ctx + row
    seg = np.zeros(span_hi - span_lo, dtype=np.uint8)
    starts, lens = lay.seq_starts, lay.lengths
    a = int(np.searchsorted(starts + lens, max(span_lo, 0), side="right"))
    b = int(np.searchsorted(starts, min(span_hi, lay.stream_len),
                            side="left"))
    if b > a:
        decoded = read_fasta_ranges(input_path, [(a, b)])
        for k in range(a, b):
            s = decoded[k]
            st = int(starts[k])
            s0, s1 = max(st, span_lo), min(st + len(s), span_hi)
            if s1 > s0:
                seg[s0 - span_lo : s1 - span_lo] = s[s0 - st : s1 - st]
    rows = np.lib.stride_tricks.as_strided(
        seg, shape=(hi - lo, row), strides=(core, 1))
    return np.ascontiguousarray(rows)


def multihost_stream_counts(ctx: MultihostContext,
                            sequences: Sequence[np.ndarray] | None,
                            length: int, both: bool,
                            flat_codes: np.ndarray | None = None,
                            input_path: str | None = None,
                            lengths: np.ndarray | None = None):
    """Count the full corpus across all processes.

    Process 0 passes the parsed ``sequences`` and receives the exact
    mirrored host table and ltot.  Worker processes pass
    ``sequences=None`` with ``input_path`` + ``lengths`` (from
    io.fasta.read_fasta_lengths): they decode only the sequences their
    block touches, take part in every collective — count table (int32
    sum), ltot (int64 sum), suspicion flags (gather), in that order on
    every process — and receive (None, ltot): the mirror and the fix-up
    run in process 0, the only process that continues past counting.
    The 3-bit wire only, as in the reference.

    Every process logs, after the collectives, the block it counted and
    how many histogram kernels it launched for it (0 on the CPU): the
    evidence that each rank's count ran on its own devices.
    """
    if sequences is not None:
        stream, lay = build_stream(sequences, length, flat_codes=flat_codes)
    else:
        stream = None
        lay = make_layout(np.asarray(lengths, dtype=np.int64), length)
    per, lay = shard_layout(lay, sum(ctx.shards))
    lo, hi = _local_block(ctx, per)
    if stream is not None:
        rows = chunk_rows(stream, lay)[lo:hi]
    else:
        rows = _stream_segment_rows(input_path, lay, lo, hi)
    launched, tiers = hist.LAUNCHES, dict(hist.TIER_LAUNCHES)
    counts, ltot, susp, _ = stream_counts_over_mesh(
        pack_codes_fused_native(rows), None, lay.row, lay.ctx, length, both,
        -1, ctx.mesh, per, base=lo)
    launched = hist.LAUNCHES - launched
    tiers = {t: n - tiers[t] for t, n in hist.TIER_LAUNCHES.items()}

    counts = _all_reduce_sum(ctx, counts)
    ltot = sync_read(_all_reduce_sum(ctx, ltot), int)
    susp = _all_gather_blocks(ctx, susp.to(torch.uint8), per)
    get_logger().info(
        f"multi-process count: rank {ctx.rank} of {ctx.world} counted chunk "
        f"rows [{lo}, {hi}) on {len(ctx.mesh)} x {ctx.mesh[0].type}, "
        f"histogram launches {launched} "
        f"(shared {tiers['shared']}, l2 {tiers['l2']}), backend {ctx.backend}")
    if sequences is None:
        # worker: collectives done; the table and fix-up are process 0's
        return None, ltot

    counts_np = sync_read(stream_compact(counts, length, both)[0]).numpy()
    ids, dvs, ltot_delta = stream_fixup_pairs(
        stream, lay, sync_read(susp).numpy().astype(bool), both)
    np.add.at(counts_np, ids, dvs)
    return counts_np, ltot + ltot_delta


def multihost_bg_counts(ctx: MultihostContext,
                        sequences: Sequence[np.ndarray] | None, order: int,
                        input_path: str | None = None,
                        n_total: int | None = None) -> List[np.ndarray]:
    """Background (k+1)-mer counts across processes: each process scans
    a contiguous block of the sequences with the threaded native counter,
    one int64 all-reduce merges the vectors.  Worker mode
    (``sequences=None`` + ``input_path``/``n_total``): decode only this
    process's block (io.fasta.read_fasta_ranges)."""
    n = n_total if sequences is None else len(sequences)
    lo_s, hi_s = ctx.rank * n // ctx.world, (ctx.rank + 1) * n // ctx.world
    if sequences is None:
        decoded = read_fasta_ranges(input_path, [(lo_s, hi_s)])
        shard = [decoded[i] for i in range(lo_s, hi_s)]
    else:
        shard = list(sequences[lo_s:hi_s])
    flat = np.concatenate([c.astype(np.int64)
                           for c in count_kmers(shard, order)])
    out = sync_read(_all_reduce_sum(ctx, torch.from_numpy(flat))).numpy()
    res, off = [], 0
    for k in range(order + 1):
        width = 4 ** (k + 1)
        res.append(out[off : off + width].copy())
        off += width
    return res
