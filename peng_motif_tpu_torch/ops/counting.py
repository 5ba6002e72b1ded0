"""k-mer counting: the vectorized non-overlap dedup, the exact engine's
batch count (:class:`CountJob`, :func:`count_patterns`), the packed wire
decode, and the host oracles.

The reference counts with a sequential rolling-hash scan
(reference: src/base_pattern.cpp:331-441).  Its non-overlap rule — a
window is counted only if no window with the same canonical pattern was
*counted* at any of the previous W-1 window positions of the same
sequence (src/base_pattern.cpp:362-366) — is evaluated here as the
*naive* rule "no same-id window in the previous W-1 positions at all"
(W-1 shifted equality compares) plus a per-row *suspicion* flag for rows
holding a window whose blocker is itself blocked: the only place naive
and exact can diverge.  Suspicious rows are re-counted exactly on host
(here :func:`_apply_fixup_rows`; for the stream layout
ops/stream_count.stream_fixup_pairs).

``ltot`` counts *all* processed windows, including ones rejected by the
non-overlap rule (src/base_pattern.cpp:367).

The batch count runs on a [B, L] code batch in one device program whose
4**W table comes from the histogram kernel (ops/histogram.py); on a CPU
tensor the kernel's plain version runs.  Two parts of the reference's
form are left out: the uint16 wire of the canonical slice, with its
int32 refetch (``_count_device_packed_i32``), because the slice is
fetched as int32; and ``count_device_full`` and ``fixup_delta_pairs``,
which nothing in the reference package calls.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from . import encoding
from ..utils.logging_utils import sync_read, upload
from .histogram import histogram


def _host_count_max_bases() -> int:
    """Inputs at or below this many bases count on host (see CountJob).

    Default: everything.  The batch device path materializes the whole
    [N, L] window machinery in one program, while the device *engine*
    counts through the slabbed stream path and is unaffected by this
    knob.  ``PENG_COUNT_HOST_MAX_BASES=0`` forces the batch device
    path."""
    return int(os.environ.get("PENG_COUNT_HOST_MAX_BASES", 1 << 62))


def _post_n_chains(codes: torch.Tensor, valid: torch.Tensor, length: int):
    """The reference scan's post-N skip along its stride-(W+1) chains.

    The scan, on hitting an N at position q right after a processed
    window, advances the next window start to q+2 — so the (otherwise
    clean) window starting at q+1 is neither counted nor included in
    ltot (src/base_pattern.cpp:360-382).  Window s is skipped iff
    seq[s-1] is an N and the window s-W-1 was processed:

        skip(s) = a(s) & !skip(s-W-1),   a(s) = isN(s-1) & valid(s-W-1)

    Along each chain the recurrence has the closed form "a(s), and the
    run of consecutive a's ending at s has odd length": one cummax over
    the chain axis.  Needs NW > W+1.  Returns (skip [B, NW], a laid out
    [B, m, W+1] along the chains).
    """
    n_win = valid.shape[1]
    d = length + 1
    b = valid.shape[0]
    dev = codes.device
    is_n = codes == 0
    m = -(-n_win // d)
    a_p = torch.zeros((b, m * d), dtype=torch.bool, device=dev)
    a_p[:, d:n_win] = is_n[:, d - 1 : n_win - 1] & valid[:, : n_win - d]
    a_p = a_p.view(b, m, d)
    j = torch.arange(m, dtype=torch.int32, device=dev)[None, :, None]
    last_zero = torch.cummax(torch.where(a_p, -1, j), dim=1).values
    skip = a_p & (((j - last_zero) & 1) == 1)
    return skip.reshape(b, m * d)[:, :n_win], a_p


def scan_skip_mask(codes: torch.Tensor, valid: torch.Tensor,
                   length: int) -> torch.Tensor:
    """Windows the reference scan never evaluates ([B, NW] bool; see
    :func:`_post_n_chains`); processed = valid & ~skip."""
    if valid.shape[1] <= length + 1:
        return torch.zeros_like(valid)
    return _post_n_chains(codes, valid, length)[0]


def naive_dedup(cids: torch.Tensor, length: int):
    """Vectorized dedup approximation + exactness certificate.

    cids: [B, NW] canonical ids, -1 for invalid windows.
    Returns (counted [B, NW] bool, suspicious_rows [B] bool).  Rows with
    ``suspicious_rows == False`` are provably exact; the others need the
    host fix-up.
    """
    n_win = cids.shape[1]
    valid = cids >= 0
    blocked = torch.zeros_like(valid)
    eqs = []
    for d in range(1, min(length, n_win)):
        eq = (cids[:, d:] == cids[:, :-d]) & valid[:, d:] & valid[:, :-d]
        blocked[:, d:] |= eq
        eqs.append(eq)
    counted = valid & ~blocked
    suspicious = torch.zeros(cids.shape[0], dtype=torch.bool,
                             device=cids.device)
    for d, eq in enumerate(eqs, start=1):
        suspicious |= (eq & blocked[:, :-d]).any(dim=1)
    return counted, suspicious


def _unpack_codes(buf: torch.Tensor, length: int) -> torch.Tensor:
    """BaMM codes [B, length] int32 (0 = N) from the packed wire: 2-bit
    codes, 4 per byte, then a 1-bit N mask, 8 per byte (see
    :func:`pack_codes`)."""
    c4 = (length + 3) // 4
    packed = buf[:, :c4]
    nmask = buf[:, c4:]
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=buf.device)
    c = ((packed[:, :, None] >> shifts) & 3).reshape(
        packed.shape[0], -1)[:, :length]
    bit = torch.arange(8, dtype=torch.uint8, device=buf.device)
    nm = ((nmask[:, :, None] >> bit) & 1).reshape(
        nmask.shape[0], -1)[:, :length]
    return torch.where(nm == 1, 0, c.to(torch.int32) + 1)


def _count_windows(codes: torch.Tensor, length: int, both_strands: bool):
    """(counts [4**W] int32 un-mirrored, ltot int64, suspicious [B]) of a
    [B, L] code batch, on its device."""
    fwd, rc, valid = encoding.window_ids(codes, length)
    valid &= ~scan_skip_mask(codes, valid, length)
    cids = torch.where(valid, torch.minimum(fwd, rc) if both_strands
                       else fwd, -1)
    counted, suspicious = naive_dedup(cids, length)
    # ids of uncounted windows are never read by the histogram
    counts = histogram(cids.reshape(-1), counted.reshape(-1), 4 ** length)
    return counts, valid.sum(dtype=torch.int64), suspicious


def _count_device(codes: torch.Tensor, length: int, both_strands: bool):
    """:func:`_count_windows` with the table mirrored to reverse-
    complement ids in BOTH_STRANDS mode (src/base_pattern.cpp:386-392)."""
    counts, ltot, suspicious = _count_windows(codes, length, both_strands)
    if both_strands:
        dev = counts.device
        counts = torch.where(encoding.canonical_mask_flat(length, dev), counts,
                             counts[encoding.rc_ids_flat(length, dev)])
    return counts, ltot, suspicious


def count_patterns_device(codes: torch.Tensor, length: int,
                          both_strands: bool = True):
    """Counting that never leaves the codes' device (naive dedup only, no
    host fix-up): exact whenever no row carries a same-pattern occurrence
    chain with gaps < W.  Returns (counts [4**W] int32 mirrored, ltot as a
    0-d int64 tensor): nothing here waits for the device, so a caller's
    whole function stays on it.  One histogram launch.  Use
    :func:`count_patterns` for the guaranteed-exact result."""
    counts, ltot, _ = _count_device(codes, length, both_strands)
    return counts, ltot


def _count_device_packed(buf: torch.Tensor, seq_len: int, length: int,
                         both_strands: bool):
    """Counting from packed rows (:func:`pack_codes`) with a
    transfer-minimal result: in BOTH_STRANDS mode every window counts at
    its canonical id, so only the (4^W + 4^(W/2))/2 canonical entries
    (int32) leave the device and the mirror runs on host.  Returns
    (vals, ltot, suspicious)."""
    counts, ltot, suspicious = _count_windows(
        _unpack_codes(buf, seq_len), length, both_strands)
    if both_strands:
        counts = counts[encoding.canonical_idx_flat(length, counts.device)]
    return counts, ltot, suspicious


class CountJob:
    """The exact engine's count of a padded [B, L] batch (reference
    equivalent: the single rolling scan, src/base_pattern.cpp:331-441).

    Construction starts the count — the threaded native host scan, or
    the batch device program on ``device`` — and the caller overlaps
    host work (background tables) with it; :meth:`finish` returns the
    exact, mirrored host table.  As in the reference, every size counts
    on host by default (the threaded native scan is at least as fast as
    the batch program, which holds the whole window machinery at once);
    ``PENG_COUNT_HOST_MAX_BASES`` sets the largest host-counted input
    (in bases; ``0`` sends every input to ``device``, the CPU
    included).
    """

    def __init__(self, codes_np: np.ndarray, length: int,
                 both_strands: bool, device):
        from ..native import (  # noqa: PLC0415
            count_rows_exact_native, pack_codes_fused_native)

        self._codes_np = np.ascontiguousarray(codes_np, dtype=np.uint8)
        self._length = length
        self._both = both_strands
        self._seq_len = self._codes_np.shape[1]
        self._host_thread = None
        # degenerate inputs (no sequences / all shorter than W): no
        # windows exist; the reference runs through with an empty table
        self._empty = (self._codes_np.shape[0] == 0
                       or self._seq_len < length)
        if self._empty:
            return
        device = torch.device(device)
        max_bases = _host_count_max_bases()
        if (self._codes_np.size <= max_bases
                or (max_bases > 0 and device.type == "cpu")):
            result = [None]

            def _run():
                result[0] = count_rows_exact_native(
                    self._codes_np, length, both_strands)

            self._host_result = result
            # ctypes releases the GIL: the caller's background-table
            # build overlaps with the scan
            self._host_thread = threading.Thread(target=_run, daemon=True)
            self._host_thread.start()
            return
        buf = torch.from_numpy(pack_codes_fused_native(self._codes_np))
        self._vals, self._ltot, self._susp = _count_device_packed(
            upload(buf, device), self._seq_len, length, both_strands)

    def finish(self):
        """(counts_np int32 [4**W], ltot int) with exact non-overlap
        semantics; blocks on the count."""
        from ..native import mirror_canonical_native  # noqa: PLC0415

        if self._host_thread is not None:
            self._host_thread.join()
            return self._host_result[0]
        if self._empty:
            return np.zeros(4 ** self._length, dtype=np.int32), 0
        vals = sync_read(self._vals).numpy()
        ltot = sync_read(self._ltot, int)
        susp_np = sync_read(self._susp).numpy()
        if self._both:
            counts_np = mirror_canonical_native(vals, self._length)
        else:
            counts_np = vals.astype(np.int32)
        if susp_np.any():
            rows = self._codes_np[np.flatnonzero(susp_np)]
            counts64 = counts_np.astype(np.int64)
            _apply_fixup_rows(counts64, rows, self._length, self._both)
            counts_np = counts64.astype(np.int32)
        return counts_np, ltot


def _apply_fixup_rows(counts64: np.ndarray, rows: np.ndarray, length: int,
                      both_strands: bool):
    """Add the exact-minus-naive dedup delta of suspicious rows (native
    batch recount) to a mirrored table, in place."""
    from ..native import dedup_fixup_rows_native  # noqa: PLC0415

    ids, dv = dedup_fixup_rows_native(rows, length, both_strands)
    for cid, d in zip(ids.tolist(), dv.tolist()):
        counts64[cid] += d
        if both_strands:
            rcid = _np_revcomp_id(cid, length)
            if rcid != cid:
                counts64[rcid] += d


def count_patterns(codes, length: int, both_strands: bool = True):
    """Count non-overlapping pattern occurrences over a sequence batch.

    Args:
      codes: [B, L] BaMM codes (0 = N / padding), numpy or a torch tensor
        (counted on its device).
      length: pattern length W.
      both_strands: canonicalize ids to min(id, revcomp) and mirror counts.

    Returns:
      (counts [4**W] int32 tensor on the codes' device, mirrored to rc ids
      when both_strands; ltot int, the number of processed windows).
    """
    codes = torch.as_tensor(codes)
    if codes.shape[0] == 0 or codes.shape[1] < length:
        # no window fits: the reference scan finds nothing
        return torch.zeros(4 ** length, dtype=torch.int32,
                           device=codes.device), 0
    counts, ltot, suspicious = _count_device(codes, length, both_strands)
    susp_np = sync_read(suspicious).numpy()
    if susp_np.any():
        counts_np = sync_read(counts).numpy().astype(np.int64)
        apply_dedup_fixup(counts_np, sync_read(codes).numpy(), susp_np,
                          length, both_strands)
        counts = upload(counts_np.astype(np.int32), codes.device)
    return counts, sync_read(ltot, int)


def apply_dedup_fixup(counts_np: np.ndarray, codes, susp_np: np.ndarray,
                      length: int, both_strands: bool):
    """Exactly re-count the suspicious rows on host and apply the sparse
    delta in place to a (post-mirror) count table."""
    delta: dict = {}
    for row in np.asarray(codes)[np.flatnonzero(susp_np)]:
        for cid, dv in host_row_recount(row, length, both_strands).items():
            delta[cid] = delta.get(cid, 0) + dv
    for cid, dv in delta.items():
        counts_np[cid] += dv
        if both_strands:
            rcid = _np_revcomp_id(cid, length)
            if rcid != cid:
                counts_np[rcid] += dv


# ---------------------------------------------------------------------------
# host side
# ---------------------------------------------------------------------------


def _n_canonical(length: int) -> int:
    """Number of ids with id <= revcomp(id): (4^W + #palindromes) / 2;
    palindromes exist only for even W (middle base would have to equal
    its own complement)."""
    pal = 4 ** (length // 2) if length % 2 == 0 else 0
    return (4 ** length + pal) // 2


def pack_codes(codes_np: np.ndarray) -> np.ndarray:
    """[B, ceil(L/4) + ceil(L/8)] uint8 wire rows: 2-bit base codes (4 per
    byte) followed by a 1-bit N mask.  Numpy form of the native fused
    chunk + pack (native/pengnative.cpp chunk_pack_native), kept as its
    test oracle."""
    c = np.ascontiguousarray(codes_np, dtype=np.uint8)
    b, length = c.shape
    n = c == 0
    b2 = (c - np.uint8(1)) & np.uint8(3)
    pad4 = (-length) % 4
    if pad4:
        b2 = np.pad(b2, ((0, 0), (0, pad4)))
    b2 = b2.reshape(b, -1, 4)
    packed = (b2[:, :, 0] | (b2[:, :, 1] << 2) | (b2[:, :, 2] << 4)
              | (b2[:, :, 3] << 6))
    nmask = np.packbits(n, axis=1, bitorder="little")
    return np.concatenate([packed, nmask], axis=1)


def _np_revcomp_id(pattern: int, length: int) -> int:
    out = 0
    for p in range(length):
        c = (pattern >> (2 * p)) & 3
        out += (3 - c) * (4 ** (length - 1 - p))
    return out


def _row_cids_processed(row_codes: np.ndarray, length: int,
                        both_strands: bool):
    """Per-row canonical ids with the processed mask applied (clean
    windows minus the reference scan's post-N skip: the scan, on hitting
    an N right after a processed window, advances past the next window
    start, src/base_pattern.cpp:360-382).  Returns cid [NW] with -1 at
    unprocessed windows."""
    W = length
    c = np.asarray(row_codes, dtype=np.int64)
    n_win = c.shape[0] - W + 1
    if n_win <= 0:
        return np.empty(0, dtype=np.int64)
    valid = np.ones(n_win, dtype=bool)
    fwd = np.zeros(n_win, dtype=np.int64)
    rc = np.zeros(n_win, dtype=np.int64)
    for p in range(W):
        cc = c[p : p + n_win]
        valid &= cc > 0
        fwd += (cc - 1) * (4 ** p)
        rc += (4 - cc) * (4 ** (W - 1 - p))
    d = W + 1
    skip = np.zeros(n_win, dtype=bool)
    for s in range(d, n_win):
        skip[s] = (c[s - 1] == 0) and valid[s - d] and not skip[s - d]
    processed = valid & ~skip
    return np.where(processed, np.minimum(fwd, rc) if both_strands else fwd,
                    -1)


def host_row_recount(row_codes: np.ndarray, length: int, both_strands: bool):
    """Exact greedy recount of one sequence, returned as the sparse count
    delta {canonical_id: exact - naive} (reference semantics:
    src/base_pattern.cpp:331-393).  "naive" replicates the device's
    vectorized decision (processed mask + W-1-shift blocking); "exact"
    is the greedy last-accepted-position rule over processed windows,
    equivalent to the reference scan automaton."""
    W = length
    cid = _row_cids_processed(row_codes, length, both_strands)
    n_win = cid.shape[0]
    if n_win == 0:
        return {}

    blocked = np.zeros(n_win, dtype=bool)
    for d in range(1, min(W, n_win)):
        eq = (cid[d:] == cid[:-d]) & (cid[d:] >= 0) & (cid[:-d] >= 0)
        blocked[d:] |= eq
    naive = (cid >= 0) & ~blocked

    exact = np.zeros(n_win, dtype=bool)
    last: dict = {}
    for j in range(n_win):
        i = int(cid[j])
        if i < 0:
            continue
        if i not in last or j - last[i] >= W:
            exact[j] = True
            last[i] = j

    delta: dict = {}
    for j in np.flatnonzero(naive != exact):
        i = int(cid[j])
        delta[i] = delta.get(i, 0) + (1 if exact[j] else -1)
    return delta


def reference_scan_row(row_codes: np.ndarray, length: int,
                       both_strands: bool):
    """Direct transcription of the reference's rolling scan for one row
    (src/base_pattern.cpp:331-393 / 395-441): returns
    ({canonical_id: count}, ltot).  Test oracle for the vectorized
    processed-mask + dedup formulation."""
    W = length
    c = np.asarray(row_codes, dtype=np.int64)
    L = c.shape[0]
    counts: dict = {}
    last: dict = {}
    ltot = 0
    i = 0
    while i < L:
        p = 0
        pid = 0
        while p < W and i < L and c[i] > 0:
            pid += (c[i] - 1) * (4 ** p)
            p += 1
            i += 1
        if p < W:
            i += 1  # outer-loop increment after `continue`
            continue
        while True:
            s = i - W  # window start
            cid = min(pid, _np_revcomp_id(int(pid), W)) if both_strands \
                else int(pid)
            if cid not in last or last[cid] + W <= s:
                counts[cid] = counts.get(cid, 0) + 1
                last[cid] = s
            ltot += 1
            if i >= L or c[i] == 0:
                break
            pid = pid // 4 + (c[i] - 1) * (4 ** (W - 1))
            i += 1
        i += 2  # explicit i++ after the stream + outer-loop increment
    return counts, ltot
