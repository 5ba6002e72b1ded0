"""Native C++ host helpers, bound via ctypes.

The library is built from the port's own sources into
``peng_motif_tpu_torch/_build/libpengnative.so`` at first use, and again
whenever a source is newer than the library: ``csrc/pengnative.cpp`` (a
byte-for-byte copy of the reference package's ``native/pengnative.cpp``,
held equal by tests/test_torch_no_jax.py while both exist) and
``csrc/hostcount.cpp`` (the port's own host count),
``csrc/seedsort.cpp`` (the host's part of the device engine's seed
z-sort and its walk) and ``csrc/replay.cpp`` (the climb's seen-set
replay and its text).  This module binds only the functions the port
calls.

The host side's parity with the reference binary rests on this library
(libstdc++ tie-exact sorts, reference-order float folds), so there is no
degraded pure-Python path: a failed build or load raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Sequence, Union

import numpy as np

from ..utils.logging_utils import span

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
_SRC = os.path.join(_PKG, "csrc", "pengnative.cpp")
_SRCS = (_SRC, os.path.join(_PKG, "csrc", "hostcount.cpp"),
         os.path.join(_PKG, "csrc", "seedsort.cpp"),
         os.path.join(_PKG, "csrc", "replay.cpp"))
_SO = os.path.join(BUILD_DIR, "libpengnative.so")

_lock = threading.Lock()
_lib = None

_c_f32p = ctypes.POINTER(ctypes.c_float)
_c_i32p = ctypes.POINTER(ctypes.c_int32)
_c_i64p = ctypes.POINTER(ctypes.c_int64)
_c_i8p = ctypes.POINTER(ctypes.c_int8)
_c_u8p = ctypes.POINTER(ctypes.c_uint8)
_c_u32p = ctypes.POINTER(ctypes.c_uint32)
_c_u64p = ctypes.POINTER(ctypes.c_uint64)


def compile_library(src: Union[str, Sequence[str]], so: str,
                    cmd: List[str]) -> str:
    """Run ``cmd + ["-o", <tmp>, *sources]`` when ``so`` is missing or
    older than one of the sources (``src``: one path or several), then
    move the result into place atomically (a per-process temp name, so
    concurrent builders never see a half-written library).  Returns the
    compiler's output; raises RuntimeError with it when the build
    fails."""
    srcs = [src] if isinstance(src, str) else list(src)
    for path in srcs:
        if not os.path.exists(path):
            raise RuntimeError(f"source not found: {path}")
    if os.path.exists(so) and all(
            os.path.getmtime(so) >= os.path.getmtime(p) for p in srcs):
        return ""
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(cmd + ["-o", tmp] + srcs, capture_output=True,
                              text=True, timeout=600)
    except OSError as e:
        raise RuntimeError(f"cannot run {cmd[0]}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"building {os.path.basename(so)} failed ({' '.join(cmd)}):\n"
            + proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return proc.stdout + proc.stderr


def _declare(lib) -> None:
    sig = {
        "fasta_open": ([ctypes.c_char_p, _c_i64p, _c_i64p, _c_i64p,
                        ctypes.c_char_p, ctypes.c_int64,
                        ctypes.c_char_p, ctypes.c_int64, _c_i64p],
                       ctypes.c_int64),
        "fasta_take": ([ctypes.c_int64, _c_u8p, _c_i64p, _c_i64p],
                       ctypes.c_int64),
        "bg_count_kmers": ([_c_u8p, _c_i64p, ctypes.c_int64, ctypes.c_int,
                            _c_i64p], None),
        "build_stream_native": ([_c_u8p, _c_i64p, ctypes.c_int64,
                                 ctypes.c_int64, _c_u8p], None),
        "chunk_pack_native": ([_c_u8p] + [ctypes.c_int64] * 5 + [_c_u8p],
                              None),
        "chunk_pack2_native": ([_c_u8p] + [ctypes.c_int64] * 5 + [_c_u8p],
                               None),
        "mirror_canonical_i32": ([_c_i32p, ctypes.c_int, _c_i32p], None),
        "stream_fixup_native": (
            [_c_u8p, ctypes.c_int64, _c_i64p, _c_i64p, ctypes.c_int64,
             _c_i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
             _c_i64p, _c_i32p, ctypes.c_int64, _c_i64p],
            ctypes.c_int64),
        "bg_prob_table_native": ([_c_f32p, _c_i64p, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int, _c_f32p], None),
        "base_stats_table": ([_c_i32p, _c_f32p, ctypes.c_int64,
                              ctypes.c_int64, _c_f32p, _c_f32p], None),
        "zscore_sort_prefix": ([_c_f32p, ctypes.c_uint64, ctypes.c_float,
                                _c_u32p], None),
        "select_patterns_walk": ([_c_u32p, _c_f32p, _c_i32p, ctypes.c_int64,
                                  ctypes.c_int, ctypes.c_float,
                                  ctypes.c_int32, ctypes.c_int, ctypes.c_int,
                                  _c_u32p], ctypes.c_int64),
        "calculate_s_single": ([_c_f32p, _c_f32p, _c_f32p, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int], ctypes.c_float),
        "calculate_d_bg_single": ([_c_f32p, _c_f32p, ctypes.c_int,
                                   ctypes.c_int], ctypes.c_float),
        "calculate_best_overlap_native": (
            [_c_f32p, _c_f32p, ctypes.c_int, ctypes.c_uint64,
             _c_f32p, _c_f32p, ctypes.c_int, ctypes.c_uint64,
             ctypes.c_int, _c_f32p, ctypes.c_int,
             _c_f32p, ctypes.POINTER(ctypes.c_int),
             ctypes.POINTER(ctypes.c_int)], None),
        "float_sort_indices_asc": ([_c_f32p, ctypes.c_uint64, _c_u32p], None),
        # the host count (hostcount.cpp); count_rows_exact is the scan
        # it replaced, which the tests hold it to
        "host_count_scan": ([_c_u8p, ctypes.c_int64, ctypes.c_int64,
                             ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             _c_i32p], ctypes.c_int64),
        "host_count_mirror": ([_c_i32p, ctypes.c_int, ctypes.c_int], None),
        "count_rows_exact": ([_c_u8p, ctypes.c_int64, ctypes.c_int64,
                              ctypes.c_int, ctypes.c_int, ctypes.c_int,
                              _c_i32p], ctypes.c_int64),
        # the device engine's seeds (seedsort.cpp)
        "seed_sort_finish": ([_c_f32p, ctypes.c_int64, _c_i64p,
                              ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                              _c_u32p], None),
        "seed_walk_prefix": ([_c_u32p, _c_f32p, _c_i32p, ctypes.c_int64,
                              ctypes.c_int, ctypes.c_float, ctypes.c_int32,
                              ctypes.c_int, ctypes.c_int, _c_i64p],
                             ctypes.c_int64),
        # the device engine's climb replay (replay.cpp)
        "climb_replay": ([ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
                          ctypes.c_int64, _c_u8p, _c_i32p, _c_i64p, _c_f32p,
                          _c_f32p, _c_i32p, _c_i64p, _c_f32p, _c_f32p,
                          _c_i32p, _c_i64p, _c_f32p, _c_f32p, _c_f32p,
                          _c_i64p, _c_i32p, ctypes.c_int, ctypes.c_char_p,
                          _c_u8p, _c_i8p, _c_i64p, _c_f32p, _c_f32p,
                          _c_i64p, _c_i8p, _c_i64p, _c_f32p, _c_f32p,
                          ctypes.c_int64, _c_u8p, ctypes.c_int64, _c_i64p],
                         ctypes.c_int64),
        # the exact engine (pipeline.Peng._process_exact, pattern_tables)
        "pack_codes_native": ([_c_u8p, ctypes.c_int64, ctypes.c_int64,
                               _c_u8p], None),
        "dedup_fixup_rows": ([_c_u8p, ctypes.c_int64, ctypes.c_int64,
                              ctypes.c_int, ctypes.c_int, _c_i64p, _c_i32p],
                             ctypes.c_int64),
        "zscore_sort_indices": ([_c_f32p, ctypes.c_uint64, _c_u32p], None),
        "base_log_pvalues_table": ([_c_i32p, _c_f32p, ctypes.c_int64,
                                    _c_f32p], None),
        "base_opt_score": ([ctypes.c_int, ctypes.c_uint32, ctypes.c_float,
                            ctypes.c_uint64, ctypes.c_uint32],
                           ctypes.c_float),
        "iupac_aggregate_exact": ([_c_i32p, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, _c_i32p, _c_f32p, _c_f32p,
                                   _c_u64p, _c_f32p, _c_f32p], None),
        "iupac_aggregate_score": ([_c_i32p, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, _c_i32p, _c_f32p, _c_f32p,
                                   ctypes.c_int, ctypes.c_uint64,
                                   ctypes.c_uint32, _c_u64p]
                                  + [_c_f32p] * 5, None),
        "em_optimize_batch": ([_c_f32p, _c_f32p, _c_f32p, ctypes.c_int,
                               ctypes.c_int, ctypes.c_float, ctypes.c_float,
                               ctypes.c_int, ctypes.c_int], None),
    }
    for name, (argtypes, restype) in sig.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype


def get_lib() -> ctypes.CDLL:
    """Load the native library, building it first if needed.  Raises
    RuntimeError (build) or OSError (load) on failure."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock, span("lib.native"):
        if _lib is None:
            # -ffp-contract=off is parity-critical: FMA contraction would
            # change float rounding vs the reference binary.  -march=native
            # is byte-safe (elementwise IEEE ops are correctly rounded in
            # any vector width, and g++ never vectorizes FP reductions
            # without -ffast-math); the library is built on the host that
            # runs it, and on the baseline ISA where g++ refuses the flag.
            base = ["g++", "-O3", "-std=c++17", "-ffp-contract=off",
                    "-shared", "-fPIC"]
            try:
                compile_library(_SRCS, _SO, base + ["-march=native"])
            except RuntimeError:
                compile_library(_SRCS, _SO, base)
            lib = ctypes.CDLL(_SO)
            _declare(lib)
            _lib = lib
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


# ---------------------------------------------------------------------------
# parsing and background
# ---------------------------------------------------------------------------


def parse_fasta_native(filepath: str, alphabet=None):
    """Native FASTA parse into a SequenceSet; None for a non-standard
    alphabet or a file the parser cannot open (the caller's Python
    parser then raises the OSError)."""
    from ..alphabets import STANDARD  # noqa: PLC0415
    from ..io.fasta import FastaFormatError, SequenceSet  # noqa: PLC0415

    if alphabet is not None and alphabet.alphabet_type != "STANDARD":
        return None
    lib = get_lib()
    import sys  # noqa: PLC0415

    n_seq = ctypes.c_int64()
    total = ctypes.c_int64()
    n_empty = ctypes.c_int64()
    n_undef = ctypes.c_int64()
    header_buf = ctypes.create_string_buffer(65536)
    undef_buf = ctypes.create_string_buffer(1 << 20)
    handle = lib.fasta_open(filepath.encode(), ctypes.byref(n_seq),
                            ctypes.byref(total), ctypes.byref(n_empty),
                            header_buf, ctypes.c_int64(65536),
                            undef_buf, ctypes.c_int64(1 << 20),
                            ctypes.byref(n_undef))
    if handle == -2:
        raise FastaFormatError(
            f"FASTA sequence contains space character: {filepath}")
    if handle == -3:
        raise FastaFormatError(f"Wrong FASTA format: {filepath}")
    if handle <= 0:
        return None
    warnings = []
    for _ in range(int(n_empty.value)):
        # reference: SequenceSet.cpp:344-348
        warnings.append(
            f"Warning: Ignore FASTA entry without sequence: {filepath}")
    # reference quirk: the EOF-flushed (last) entry warns per undefined
    # base (SequenceSet.cpp:395-404)
    if int(n_undef.value):
        hdr = header_buf.value.decode(errors="replace")
        for ch in undef_buf.value.decode(errors="replace"):
            warnings.append("Warning: The FASTA file contains an undefined "
                            f"base: {ch} at sequence {hdr}")
    for w in warnings:
        print(w, file=sys.stderr)
    codes = np.empty(int(total.value), dtype=np.uint8)
    lengths = np.empty(int(n_seq.value), dtype=np.int64)
    base_counts = np.empty(4, dtype=np.int64)
    rc = lib.fasta_take(handle, _ptr(codes, ctypes.c_uint8),
                        _ptr(lengths, ctypes.c_int64),
                        _ptr(base_counts, ctypes.c_int64))
    if rc != 0:
        raise RuntimeError(f"native FASTA parse lost its handle: {filepath}")
    sset = SequenceSet(filepath=filepath, alphabet=alphabet or STANDARD)
    sset.warnings = warnings
    sset._flat_codes = codes  # contiguous buffer: fast padded()
    offset = 0
    for length in lengths:
        sset.sequences.append(codes[offset : offset + int(length)])
        sset.headers.append("")
        offset += int(length)
    tot = base_counts.sum()
    sset.base_frequencies = (
        base_counts.astype(np.float32) / np.float32(tot) if tot else
        np.zeros(4, dtype=np.float32))
    # O(1) undefined-base count (total bases minus defined): saves the
    # engine a full-corpus count_nonzero scan
    sset.n_undefined = int(total.value) - int(tot)
    return sset


def bg_count_kmers_native(sequences: Sequence[np.ndarray], order: int):
    """(k+1)-mer count vectors for k = 0..order with reference N-window
    semantics (see pengnative.cpp); None above order 8, which the
    reference's kmer ids do not cover."""
    if order > 8:
        return None
    lib = get_lib()
    lengths = np.array([len(s) for s in sequences], dtype=np.int64)
    codes = (np.concatenate([np.asarray(s, dtype=np.uint8).ravel()
                             for s in sequences])
             if len(sequences) else np.empty(0, dtype=np.uint8))
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    out = np.empty(sum(4 ** (k + 1) for k in range(order + 1)),
                   dtype=np.int64)
    lib.bg_count_kmers(_ptr(codes, ctypes.c_uint8),
                       _ptr(lengths, ctypes.c_int64),
                       ctypes.c_int64(len(sequences)), ctypes.c_int(order),
                       _ptr(out, ctypes.c_int64))
    res, off = [], 0
    for k in range(order + 1):
        n = 4 ** (k + 1)
        res.append(out[off : off + n].copy())
        off += n
    return res


def bg_prob_table_native_fn(v_list, length: int, order: int,
                            both_strands: bool) -> np.ndarray:
    """Threaded bg-probability table in the reference's exact multiply
    order (see pengnative.cpp)."""
    lib = get_lib()
    v_concat = np.concatenate([_f32(v) for v in v_list])
    v_off = np.zeros(order + 1, dtype=np.int64)
    acc = 0
    for k in range(order + 1):
        v_off[k] = acc
        acc += 4 ** (k + 1)
    out = np.empty(4 ** length, dtype=np.float32)
    lib.bg_prob_table_native(
        _ptr(v_concat, ctypes.c_float), _ptr(v_off, ctypes.c_int64),
        ctypes.c_int(order), ctypes.c_int(length),
        ctypes.c_int(1 if both_strands else 0), _ptr(out, ctypes.c_float))
    return out


# ---------------------------------------------------------------------------
# stream layout, packing, mirror and fix-up
# ---------------------------------------------------------------------------


def build_stream_fill_native(flat: np.ndarray, lengths: np.ndarray,
                             w: int, stream: np.ndarray) -> None:
    """Fill the gap-packed stream from the contiguous parse buffer
    (threaded memcpy)."""
    lib = get_lib()
    flat = np.ascontiguousarray(flat, dtype=np.uint8)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    lib.build_stream_native(_ptr(flat, ctypes.c_uint8),
                            _ptr(lengths, ctypes.c_int64),
                            ctypes.c_int64(lengths.shape[0]),
                            ctypes.c_int64(w), _ptr(stream, ctypes.c_uint8))


def chunk_pack_stream_native(stream: np.ndarray, m_pad: int, row: int,
                             core: int, ctx: int) -> np.ndarray:
    """Packed 2-bit + N-mask chunk buffer straight from the stream (fused
    chunk + pack, threaded)."""
    lib = get_lib()
    stream = np.ascontiguousarray(stream, dtype=np.uint8)
    out = np.empty(m_pad * ((row + 3) // 4 + (row + 7) // 8), dtype=np.uint8)
    lib.chunk_pack_native(_ptr(stream, ctypes.c_uint8),
                          stream.shape[0], m_pad, row, core, ctx,
                          _ptr(out, ctypes.c_uint8))
    return out


def chunk_pack_stream2_native(stream: np.ndarray, m_pad: int, row: int,
                              core: int, ctx: int) -> np.ndarray:
    """2-bit-only wire variant (no N-mask bytes; see ops/stream_count.py
    wire2 section)."""
    lib = get_lib()
    stream = np.ascontiguousarray(stream, dtype=np.uint8)
    out = np.empty(m_pad * ((row + 3) // 4), dtype=np.uint8)
    lib.chunk_pack2_native(_ptr(stream, ctypes.c_uint8),
                           stream.shape[0], m_pad, row, core, ctx,
                           _ptr(out, ctypes.c_uint8))
    return out


def mirror_canonical_native(vals: np.ndarray, length: int) -> np.ndarray:
    """Full mirrored [4**W] int32 count table from its canonical-id
    compaction (ascending canonical ids; see pengnative.cpp)."""
    lib = get_lib()
    vals = np.ascontiguousarray(vals, dtype=np.int32)
    out = np.empty(4 ** length, dtype=np.int32)
    lib.mirror_canonical_i32(_ptr(vals, ctypes.c_int32), ctypes.c_int(length),
                             _ptr(out, ctypes.c_int32))
    return out


def stream_fixup_delta_native(
    stream: np.ndarray, seq_starts: np.ndarray, seq_lens: np.ndarray,
    susp_chunks: np.ndarray, w: int, row: int, core: int, ctx: int,
    both: bool,
):
    """Native twin of ops.stream_count.stream_fixup_delta: returns
    (ids int64 [n], dvs int32 [n], ltot_delta)."""
    lib = get_lib()
    stream = np.ascontiguousarray(stream, dtype=np.uint8)
    seq_starts = np.ascontiguousarray(seq_starts, dtype=np.int64)
    seq_lens = np.ascontiguousarray(seq_lens, dtype=np.int64)
    susp_chunks = np.ascontiguousarray(susp_chunks, dtype=np.int64)
    # doubled buffers on capacity overflow (n < 0), up to the 4**14
    # distinct-id bound
    cap = 1 << 20
    while True:
        out_ids = np.empty(cap, dtype=np.int64)
        out_dv = np.empty(cap, dtype=np.int32)
        ltot_delta = ctypes.c_int64(0)
        n = lib.stream_fixup_native(
            _ptr(stream, ctypes.c_uint8), stream.shape[0],
            _ptr(seq_starts, ctypes.c_int64),
            _ptr(seq_lens, ctypes.c_int64), seq_starts.shape[0],
            _ptr(susp_chunks, ctypes.c_int64), susp_chunks.shape[0],
            w, row, core, ctx, 1 if both else 0,
            _ptr(out_ids, ctypes.c_int64), _ptr(out_dv, ctypes.c_int32),
            cap, ctypes.byref(ltot_delta))
        if n >= 0:
            return out_ids[:n], out_dv[:n], int(ltot_delta.value)
        if cap >= (1 << 28):
            raise RuntimeError("stream fix-up delta exceeds 2**28 entries")
        cap *= 2


# ---------------------------------------------------------------------------
# the exact engine's count: host scan, row packing, row fix-up
# ---------------------------------------------------------------------------


def count_rows_exact_native(codes: np.ndarray, w: int, both_strands: bool,
                            n_threads: int = 0):
    """Threaded host count of a [B, L] code batch with the reference
    scan's semantics (validity, post-N skip, greedy non-overlap,
    canonical mirroring; see hostcount.cpp): (counts int32 [4**w],
    ltot), integer-identical to pengnative.cpp's count_rows_exact.
    ``n_threads`` < 1 takes the hardware's.  Spans ``scan`` and
    ``mirror``."""
    lib = get_lib()
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    if codes.ndim != 2:
        codes = codes.reshape(1, -1)
    table = np.empty(4 ** w, dtype=np.int32)
    with span("scan"):
        ltot = lib.host_count_scan(
            _ptr(codes, ctypes.c_uint8), codes.shape[0], codes.shape[1], w,
            1 if both_strands else 0, n_threads, _ptr(table, ctypes.c_int32))
    if both_strands:
        with span("mirror"):
            lib.host_count_mirror(_ptr(table, ctypes.c_int32), w, n_threads)
    return table, int(ltot)


def pack_codes_fused_native(codes: np.ndarray) -> np.ndarray:
    """[B, ceil(L/4) + ceil(L/8)] uint8 wire rows: 2-bit codes then the
    1-bit N mask (threaded; ops/counting.pack_codes is its numpy
    form)."""
    lib = get_lib()
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    b, length = codes.shape
    out = np.empty((b, (length + 3) // 4 + (length + 7) // 8), dtype=np.uint8)
    lib.pack_codes_native(_ptr(codes, ctypes.c_uint8), b, length,
                          _ptr(out, ctypes.c_uint8))
    return out


def dedup_fixup_rows_native(rows: np.ndarray, length: int,
                            both_strands: bool):
    """Sparse count deltas (exact - naive dedup) of a batch of suspicious
    rows (see pengnative.cpp dedup_fixup_rows): (ids int64, dvs int32),
    canonical ids only."""
    lib = get_lib()
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    n_rows, row_len = rows.shape
    cap = max(1, n_rows * max(0, row_len - length + 1))
    out_ids = np.empty(cap, dtype=np.int64)
    out_dv = np.empty(cap, dtype=np.int32)
    n = lib.dedup_fixup_rows(_ptr(rows, ctypes.c_uint8), n_rows, row_len,
                             length, 1 if both_strands else 0,
                             _ptr(out_ids, ctypes.c_int64),
                             _ptr(out_dv, ctypes.c_int32))
    return out_ids[:n], out_dv[:n]


# ---------------------------------------------------------------------------
# per-pattern statistics and seed selection
# ---------------------------------------------------------------------------


def base_stats_native(counts: np.ndarray, bgp: np.ndarray, ltot: int):
    """(expected, zscores) tables with the reference's exact float/double
    promotion points (see pengnative.cpp)."""
    lib = get_lib()
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    bgp = _f32(bgp)
    n = counts.shape[0]
    expected = np.empty(n, dtype=np.float32)
    zscores = np.empty(n, dtype=np.float32)
    lib.base_stats_table(_ptr(counts, ctypes.c_int32),
                         _ptr(bgp, ctypes.c_float), n, int(ltot),
                         _ptr(expected, ctypes.c_float),
                         _ptr(zscores, ctypes.c_float))
    return expected, zscores


def zscore_sort_prefix_indices(z: np.ndarray,
                               zscore_threshold: float) -> np.ndarray:
    """Descending z-order whose above-threshold prefix (all the seed walk
    reads) is element-for-element the full libstdc++ std::sort, with the
    never-read subranges pruned (see pengnative.cpp zscore_sort_prefix)."""
    lib = get_lib()
    z = _f32(z)
    out = np.empty(z.shape[0], dtype=np.uint32)
    lib.zscore_sort_prefix(_ptr(z, ctypes.c_float), z.shape[0],
                           float(zscore_threshold), _ptr(out, ctypes.c_uint32))
    return out


def seed_sort_finish_native(z: np.ndarray, ranges, keep_end: int,
                            fin: int) -> np.ndarray:
    """The end of the prefix-pruned z-sort (see csrc/seedsort.cpp): ``z``
    holds the keys of positions [0, len(z)) as the device's partitions
    left them, ``ranges`` the (first, last, depth) triples they did not
    partition.  Returns the positions of [0, len(z)) in their sorted
    order over [0, fin): ``[:keep_end]`` is zscore_sort_prefix's."""
    z = _f32(z)
    ranges = np.ascontiguousarray(ranges, dtype=np.int64).reshape(-1, 3)
    if not 0 < keep_end <= fin <= z.shape[0] or (
            ranges.size and (ranges[:, 0].min() < 0
                             or ranges[:, 1].max() > z.shape[0])):
        raise ValueError("seed_sort_finish: ranges outside the fetched keys")
    perm = np.empty(fin, dtype=np.uint32)
    get_lib().seed_sort_finish(
        _ptr(z, ctypes.c_float), z.shape[0], _ptr(ranges, ctypes.c_int64),
        ranges.shape[0], keep_end, fin, _ptr(perm, ctypes.c_uint32))
    return perm


def seed_walk_prefix_native(ids, z, counts, w: int, z_thr: float,
                            count_thr: int, single_stranded: bool,
                            filter_neighbors: bool) -> np.ndarray:
    """The seed walk (reference: src/base_pattern.cpp:443-515) over a
    z-sorted prefix: ``ids`` the prefix's pattern ids, ``z`` and
    ``counts`` their z-scores and counts.  Returns the prefix positions
    of the seeds, in walk order."""
    ids = np.ascontiguousarray(ids, dtype=np.uint32)
    z = _f32(z)
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    n = ids.shape[0]
    if z.shape[0] != n or counts.shape[0] != n:
        raise ValueError("seed_walk_prefix: arrays of unequal lengths")
    if n and int(ids.max()) >= 4 ** w:
        raise ValueError(f"seed_walk_prefix: an id beyond 4**{w}")
    out = np.empty(max(n, 1), dtype=np.int64)
    n_sel = get_lib().seed_walk_prefix(
        _ptr(ids, ctypes.c_uint32), _ptr(z, ctypes.c_float),
        _ptr(counts, ctypes.c_int32), n, w, z_thr, count_thr,
        1 if single_stranded else 0, 1 if filter_neighbors else 0,
        _ptr(out, ctypes.c_int64))
    if n_sel < 0:
        raise MemoryError(f"seed_walk_prefix: no room for 4**{w} flags")
    return out[:n_sel]


def climb_replay_native(trace, seed_ids, w: int, sim_table: np.ndarray,
                        letters: str):
    """The climb's seen-set replay and its text (see csrc/replay.cpp)
    over a fetched walk trace (``ops/climb.WalkTrace``), one walk per
    entry of ``seed_ids``.  Returns (text, emitted, final_digits,
    final_counts, final_expected, final_bgp, row_start, row_digits,
    row_counts, row_expected, row_score): the rows of seed s are
    ``[row_start[s], row_start[s + 1])``."""
    improved = np.ascontiguousarray(trace.improved, dtype=np.uint8)
    acc_idx = np.ascontiguousarray(trace.acc_idx, dtype=np.int32)
    T, S, R = acc_idx.shape
    seeds = np.ascontiguousarray(seed_ids, dtype=np.int64).reshape(-1)
    sim = np.ascontiguousarray(sim_table, dtype=np.int32)
    step = {"chosen_idx": np.int32, "chosen_counts": np.int64,
            "chosen_expected": np.float32, "chosen_bgp": np.float32,
            "acc_n": np.int32}
    row = {"acc_counts": np.int64, "acc_expected": np.float32,
           "acc_score": np.float32}
    seed = {"init_counts": np.int64, "init_expected": np.float32,
            "init_bgp": np.float32, "init_score": np.float32}
    a = {}
    for names, shape in ((step, (T, S)), (row, (T, S, R)), (seed, (S,))):
        for name, dtype in names.items():
            # astype truncates the f32 counts as int() does
            a[name] = np.ascontiguousarray(getattr(trace, name), dtype=dtype)
            if a[name].shape != shape:
                raise ValueError(f"climb_replay: {name} has shape "
                                 f"{a[name].shape}, not {shape}")
    if improved.shape != (T, S) or seeds.shape != (S,):
        raise ValueError("climb_replay: the trace and the seeds disagree")
    if sim.ndim != 2 or sim.shape[0] != len(letters):
        raise ValueError("climb_replay: a similar-letter table per letter")
    # every printed row is a seed's or an accepted one
    row_cap = S + int(np.clip(a["acc_n"], 0, R).sum())
    text_cap = row_cap * (w + 160) + S * (2 * w + 40)
    emitted = np.empty(S, dtype=np.uint8)
    final_digits = np.empty((S, w), dtype=np.int8)
    final_counts = np.empty(S, dtype=np.int64)
    final_expected = np.empty(S, dtype=np.float32)
    final_bgp = np.empty(S, dtype=np.float32)
    row_start = np.empty(S + 1, dtype=np.int64)
    row_digits = np.empty((row_cap, w), dtype=np.int8)
    row_counts = np.empty(row_cap, dtype=np.int64)
    row_expected = np.empty(row_cap, dtype=np.float32)
    row_score = np.empty(row_cap, dtype=np.float32)
    text = np.empty(max(text_cap, 1), dtype=np.uint8)
    text_len = ctypes.c_int64(0)
    f32, i32, i64 = ctypes.c_float, ctypes.c_int32, ctypes.c_int64
    n_rows = get_lib().climb_replay(
        S, w, T, R, _ptr(improved, ctypes.c_uint8),
        _ptr(a["chosen_idx"], i32), _ptr(a["chosen_counts"], i64),
        _ptr(a["chosen_expected"], f32), _ptr(a["chosen_bgp"], f32),
        _ptr(acc_idx, i32), _ptr(a["acc_counts"], i64),
        _ptr(a["acc_expected"], f32), _ptr(a["acc_score"], f32),
        _ptr(a["acc_n"], i32), _ptr(a["init_counts"], i64),
        _ptr(a["init_expected"], f32), _ptr(a["init_bgp"], f32),
        _ptr(a["init_score"], f32), _ptr(seeds, i64), _ptr(sim, i32),
        sim.shape[1], letters.encode("ascii"),
        _ptr(emitted, ctypes.c_uint8), _ptr(final_digits, ctypes.c_int8),
        _ptr(final_counts, i64), _ptr(final_expected, f32),
        _ptr(final_bgp, f32), _ptr(row_start, i64),
        _ptr(row_digits, ctypes.c_int8), _ptr(row_counts, i64),
        _ptr(row_expected, f32), _ptr(row_score, f32), row_cap,
        _ptr(text, ctypes.c_uint8), text.shape[0], ctypes.byref(text_len))
    if n_rows == -1:
        raise OverflowError(f"climb_replay: 11**{w} IUPAC keys do not fit "
                            "in 64 bits")
    if n_rows == -3:
        raise ValueError("climb_replay: a walk runs past the trace or names "
                         "a candidate outside its tables")
    if n_rows < 0:
        raise RuntimeError("climb_replay: the rows outgrew their buffers")
    return (text[:text_len.value].tobytes().decode("ascii"),
            emitted.astype(bool), final_digits, final_counts, final_expected,
            final_bgp, row_start, row_digits[:n_rows], row_counts[:n_rows],
            row_expected[:n_rows], row_score[:n_rows])


def select_patterns_walk_native(order, z, counts, w: int, z_thr: float,
                                count_thr: int, single_stranded: bool,
                                filter_neighbors: bool) -> np.ndarray:
    """Seed-selection threshold walk (reference:
    src/base_pattern.cpp:443-515); the selected ids in walk order."""
    lib = get_lib()
    order = np.ascontiguousarray(order, dtype=np.uint32)
    z = _f32(z)
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    # every selection satisfies NOT (z < thr); NaN z never breaks the walk
    cap = int(np.count_nonzero(~(z < np.float32(z_thr))))
    out = np.empty(max(cap, 1), dtype=np.uint32)
    n_sel = lib.select_patterns_walk(
        _ptr(order, ctypes.c_uint32), _ptr(z, ctypes.c_float),
        _ptr(counts, ctypes.c_int32), z.shape[0], w, z_thr, count_thr,
        1 if single_stranded else 0, 1 if filter_neighbors else 0,
        _ptr(out, ctypes.c_uint32))
    return out[:n_sel]


def zscore_sort_indices(z: np.ndarray) -> np.ndarray:
    """Descending std::sort of pattern ids by z-score with libstdc++ tie
    placement (the reference binary's, src/base_pattern.cpp:454-458)."""
    lib = get_lib()
    z = _f32(z)
    out = np.empty(z.shape[0], dtype=np.uint32)
    lib.zscore_sort_indices(_ptr(z, ctypes.c_float), z.shape[0],
                            _ptr(out, ctypes.c_uint32))
    return out


def base_log_pvalues_native(counts: np.ndarray,
                            expected: np.ndarray) -> np.ndarray:
    """Whole-table log p-values with the reference binary's libm
    semantics (see pengnative.cpp base_log_pvalues_table)."""
    lib = get_lib()
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    expected = _f32(expected)
    out = np.empty(counts.shape[0], dtype=np.float32)
    lib.base_log_pvalues_table(_ptr(counts, ctypes.c_int32),
                               _ptr(expected, ctypes.c_float),
                               counts.shape[0], _ptr(out, ctypes.c_float))
    return out


def base_opt_score_native(score_type: int, observed: int, expected,
                          pseudo: int, n_sequences: int) -> np.float32:
    """Seed optimization score (enrichment or mutual information) with
    the reference's float semantics (src/base_pattern.cpp:180-200)."""
    return np.float32(get_lib().base_opt_score(
        int(score_type), int(observed), float(expected), int(pseudo),
        int(n_sequences)))


def _aggregate_args(digit_batch, counts_table, expected_table, bgp_table):
    digit_batch = np.ascontiguousarray(digit_batch, dtype=np.int32)
    tables = (np.ascontiguousarray(counts_table, dtype=np.int32),
              _f32(expected_table), _f32(bgp_table))
    return digit_batch, tables


def iupac_aggregate_exact(digit_batch: np.ndarray, both_strands: bool,
                          counts_table: np.ndarray,
                          expected_table: np.ndarray, bgp_table: np.ndarray):
    """IUPAC aggregates of a digit batch [B, W] in the reference's fold
    order (see pengnative.cpp): (counts int64, expected f32, bgp f32)."""
    lib = get_lib()
    digits, (counts, expected, bgp) = _aggregate_args(
        digit_batch, counts_table, expected_table, bgp_table)
    b, w = digits.shape
    counts_out = np.empty(b, dtype=np.uint64)
    expected_out = np.empty(b, dtype=np.float32)
    bgp_out = np.empty(b, dtype=np.float32)
    lib.iupac_aggregate_exact(
        _ptr(digits, ctypes.c_int32), b, w, 1 if both_strands else 0,
        _ptr(counts, ctypes.c_int32), _ptr(expected, ctypes.c_float),
        _ptr(bgp, ctypes.c_float), _ptr(counts_out, ctypes.c_uint64),
        _ptr(expected_out, ctypes.c_float), _ptr(bgp_out, ctypes.c_float))
    return counts_out.astype(np.int64), expected_out, bgp_out


def iupac_aggregate_score(digit_batch: np.ndarray, both_strands: bool,
                          counts_table: np.ndarray,
                          expected_table: np.ndarray, bgp_table: np.ndarray,
                          score_type: int, pseudo_expected: int,
                          n_sequences: int):
    """Aggregation, statistics and optimization score of a candidate
    batch in one pass with the reference's float semantics: (counts i64,
    expected, bgp, zscore, logp, score), each [B] f32 but the counts."""
    lib = get_lib()
    digits, (counts, expected, bgp) = _aggregate_args(
        digit_batch, counts_table, expected_table, bgp_table)
    b, w = digits.shape
    counts_out = np.empty(b, dtype=np.uint64)
    outs = [np.empty(b, dtype=np.float32) for _ in range(5)]
    lib.iupac_aggregate_score(
        _ptr(digits, ctypes.c_int32), b, w, 1 if both_strands else 0,
        _ptr(counts, ctypes.c_int32), _ptr(expected, ctypes.c_float),
        _ptr(bgp, ctypes.c_float), int(score_type), int(pseudo_expected),
        int(n_sequences),
        _ptr(counts_out, ctypes.c_uint64),
        *[_ptr(o, ctypes.c_float) for o in outs])
    return (counts_out.astype(np.int64), *outs)


def em_optimize_native(pwms: np.ndarray, counts_f32: np.ndarray,
                       bg_f32: np.ndarray, saturation_factor: float,
                       min_threshold: float, max_iterations: int,
                       n_threads: int = 0) -> np.ndarray:
    """EM in the reference's operation order, threaded over motifs:
    the refined copy of ``pwms`` [M, W, 4] f32."""
    lib = get_lib()
    pwms = np.array(pwms, dtype=np.float32, order="C")
    counts_f32, bg_f32 = _f32(counts_f32), _f32(bg_f32)
    m, w, _ = pwms.shape
    if n_threads <= 0:
        n_threads = min(m, os.cpu_count() or 1)
    lib.em_optimize_batch(_ptr(pwms, ctypes.c_float),
                          _ptr(counts_f32, ctypes.c_float),
                          _ptr(bg_f32, ctypes.c_float), m, w,
                          float(saturation_factor), float(min_threshold),
                          int(max_iterations), int(n_threads))
    return pwms


# ---------------------------------------------------------------------------
# motif similarity, motif sort
# ---------------------------------------------------------------------------


def calculate_s_native(p1_pwm, p2_pwm, background, off1: int, off2: int,
                       l: int) -> np.float32:
    """Reference-float-order PWM similarity (see pengnative.cpp)."""
    p1, p2, bg = _f32(p1_pwm), _f32(p2_pwm), _f32(background)
    return np.float32(get_lib().calculate_s_single(
        _ptr(p1, ctypes.c_float), _ptr(p2, ctypes.c_float),
        _ptr(bg, ctypes.c_float), off1, off2, l))


def calculate_d_bg_native(p_pwm, background, l: int,
                          offset: int) -> np.float32:
    """Reference-float-order divergence from the background."""
    p, bg = _f32(p_pwm), _f32(background)
    return np.float32(get_lib().calculate_d_bg_single(
        _ptr(p, ctypes.c_float), _ptr(bg, ctypes.c_float), l, offset))


def best_overlap_native(pwm1, comp1, len1: int, sites1: int,
                        pwm2, comp2, len2: int, sites2: int,
                        both_strands: bool, background, min_overlap: int):
    """Best (s, shift, comp) over all overlaps for one motif pair
    (reference: calculate_S, src/iupac_pattern.cpp:568-615)."""
    arrs = [_f32(a) for a in (pwm1, comp1, pwm2, comp2, background)]
    out_s = ctypes.c_float()
    out_shift = ctypes.c_int()
    out_comp = ctypes.c_int()
    get_lib().calculate_best_overlap_native(
        _ptr(arrs[0], ctypes.c_float), _ptr(arrs[1], ctypes.c_float),
        len1, sites1,
        _ptr(arrs[2], ctypes.c_float), _ptr(arrs[3], ctypes.c_float),
        len2, sites2, 1 if both_strands else 0,
        _ptr(arrs[4], ctypes.c_float), min_overlap,
        ctypes.byref(out_s), ctypes.byref(out_shift), ctypes.byref(out_comp))
    return np.float32(out_s.value), int(out_shift.value), bool(out_comp.value)


def float_sort_indices_asc(values: np.ndarray) -> np.ndarray:
    """Ascending std::sort permutation (reference motif-sort semantics,
    including introsort tie placement)."""
    lib = get_lib()
    values = _f32(values)
    out = np.empty(values.shape[0], dtype=np.uint32)
    lib.float_sort_indices_asc(_ptr(values, ctypes.c_float),
                               values.shape[0], _ptr(out, ctypes.c_uint32))
    return out
