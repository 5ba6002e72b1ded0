"""k-mer counting pieces: the vectorized non-overlap dedup, the packed
wire decode, and the host oracles.

The reference counts with a sequential rolling-hash scan
(reference: src/base_pattern.cpp:331-441).  Its non-overlap rule — a
window is counted only if no window with the same canonical pattern was
*counted* at any of the previous W-1 window positions of the same
sequence (src/base_pattern.cpp:362-366) — is evaluated here as the
*naive* rule "no same-id window in the previous W-1 positions at all"
(W-1 shifted equality compares) plus a per-row *suspicion* flag for rows
holding a window whose blocker is itself blocked: the only place naive
and exact can diverge.  Suspicious rows are re-counted exactly on host
(ops/stream_count.stream_fixup_pairs).

``ltot`` counts *all* processed windows, including ones rejected by the
non-overlap rule (src/base_pattern.cpp:367).
"""

from __future__ import annotations

import numpy as np
import torch


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
