"""The count layer of PEnG-motif in plain NumPy: the FASTA corpus, the
4**W pattern table, ltot and the background (k+1)-mer counts.

Written from the upstream scan's rules (soedinglab/PEnG-motif,
src/base_pattern.cpp:331-441 and src/shared/BackgroundModel.cpp:59-84),
not from the program under test:

- A pattern id is little-endian: the base at window position p adds
  ``(code - 1) * 4**p`` (codes A=1, C=2, G=3, T=4, anything else 0 = N).
- A window holding an N is not processed.  The scan also never evaluates
  the window that starts right after an N when the window that ends
  right before that N was processed (it steps two positions past the
  N); a skipped window is not processed either.
- ltot counts every processed window.
- With both strands a window's pattern is min(id, reverse complement);
  a processed window is counted unless a counted window of the same
  pattern started fewer than W positions before it in the same sequence.
- The table is mirrored: both a pattern and its reverse complement hold
  the count of the pair.
- A background (k+1)-mer id is big-endian (the earliest base carries
  4**k).  The (k+1)-mer ending at position i (i >= k) is counted when
  none of the positions max(0, i-8)..i of its sequence is an N, or when
  its value, in which an N adds nothing, is 0.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

_CODE = np.zeros(256, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CODE[_b] = _i + 1
    _CODE[_b + 32] = _i + 1  # lower case


def read_fasta(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(codes uint8 of every sequence one after another, start offsets
    int64 [n + 1]) of a FASTA file; a record's lines are joined.  As
    upstream, a last line with no newline at its end is not read, and a
    record with no sequence is left out."""
    with open(path, "rb") as f:
        data = f.read()
    chunks, lengths = [], []
    for rec in data.split(b">")[1:]:
        nl = rec.find(b"\n")
        body = b"" if nl < 0 else rec[nl + 1:rec.rfind(b"\n") + 1]
        seq = body.replace(b"\n", b"").replace(b"\r", b"")
        if not seq:
            continue
        chunks.append(seq)
        lengths.append(len(seq))
    raw = np.frombuffer(b"".join(chunks), dtype=np.uint8)
    offsets = np.zeros(len(lengths) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    return _CODE[raw], offsets


def revcomp_ids(W: int) -> np.ndarray:
    """[4**W] reverse complement of every pattern id."""
    ids = np.arange(4 ** W, dtype=np.int64)
    rc = np.zeros_like(ids)
    for p in range(W):
        digit = (ids >> (2 * p)) & 3
        rc += (3 - digit) << (2 * (W - 1 - p))
    return rc


def count_table(codes: np.ndarray, offsets: np.ndarray, W: int,
                both: bool = True) -> Tuple[np.ndarray, int]:
    """(mirrored table int64 [4**W], ltot) of the corpus."""
    n_pos = codes.shape[0]
    nw = n_pos - W + 1
    if nw <= 0:
        return np.zeros(4 ** W, np.int64), 0
    idt = np.int32 if W <= 15 else np.int64
    # every global position g starts a window of W bases; it is valid
    # when it lies inside one sequence and holds no N
    seq_of = np.repeat(np.arange(offsets.shape[0] - 1), np.diff(offsets))
    g = np.arange(nw)
    inside = g + W <= offsets[seq_of[:nw] + 1]
    n_csum = np.zeros(n_pos + 1, dtype=np.int64)
    np.cumsum(codes == 0, out=n_csum[1:])
    valid = inside & (n_csum[W:] == n_csum[:nw])
    fwd = np.zeros(nw, dtype=idt)
    rc = np.zeros(nw, dtype=idt)
    digit = np.where(codes > 0, codes.astype(idt) - 1, 0).astype(idt)
    for p in range(W):
        d = digit[p:p + nw]
        fwd += d << (2 * p)
        rc += (3 - d) << (2 * (W - 1 - p))
    del digit
    processed = valid
    for q in np.flatnonzero(codes == 0):    # ascending: earlier skips first
        s = q + 1           # the window after the N ...
        back = s - W - 1    # ... and the one ending right before it
        if (back >= 0 and s < nw and seq_of[back] == seq_of[q] == seq_of[s]
                and processed[s] and processed[back]):
            processed[s] = False
    ltot = int(processed.sum())
    cid = np.where(processed, np.minimum(fwd, rc) if both else fwd, -1)
    del fwd, rc

    # a window is counted unless a counted window with the same pattern
    # starts 1..W-1 positions before it (windows of one pattern never
    # cross sequences: a window lies inside its sequence)
    contested = np.zeros(nw, dtype=bool)
    for d in range(1, W):
        contested[d:] |= (cid[d:] >= 0) & (cid[d:] == cid[:-d])
    counted = cid >= 0
    for s in np.flatnonzero(contested):    # ascending: greedy, in order
        lo = max(s - W + 1, 0)
        prev = np.flatnonzero(counted[lo:s] & (cid[lo:s] == cid[s]))
        counted[s] = prev.size == 0
    canon = np.bincount(cid[counted], minlength=4 ** W).astype(np.int64)
    if not both:
        return canon, ltot
    rcid = revcomp_ids(W)
    return canon[np.minimum(np.arange(4 ** W), rcid)], ltot


def bg_counts(codes: np.ndarray, offsets: np.ndarray,
              order: int) -> List[np.ndarray]:
    """(k+1)-mer count vectors int64 for k = 0..order."""
    n_pos = codes.shape[0]
    seq_start = np.repeat(offsets[:-1], np.diff(offsets))
    pos = np.arange(n_pos, dtype=np.int64)
    rel = pos - seq_start
    is_n = codes == 0
    csum = np.zeros(n_pos + 1, dtype=np.int64)
    np.cumsum(is_n, out=csum[1:])
    lo = np.maximum(pos - 8, seq_start)
    n_near = (csum[pos + 1] - csum[lo]) > 0
    digit = np.where(is_n, 0, codes.astype(np.int64) - 1)
    out = []
    v = digit
    for k in range(order + 1):
        if k:
            prev = np.zeros(n_pos, dtype=np.int64)
            prev[k:] = digit[:-k]
            v = v + prev * (4 ** k)
        ok = (rel >= k) & (~n_near | (v == 0))
        out.append(np.bincount(v[ok], minlength=4 ** (k + 1))
                   .astype(np.int64))
    return out
