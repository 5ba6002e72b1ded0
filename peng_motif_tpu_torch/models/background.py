"""Order-K homogeneous Markov background model with interpolated smoothing.

Mirrors reference: src/shared/BackgroundModel.{h,cpp}.  Counting runs in
the native library (or, fused, inside the device count program — see
:func:`bg_device_corrections`); the conditional-probability recursion is
vectorized numpy on host (the model is tiny: 4**(K+1) floats).

BaMM (k+1)-mer ids are big-endian: the earliest letter carries factor
4**k (reference: src/shared/Sequence.cpp:21-33).

N-handling quirk, reproduced exactly: the reference marks windows
containing an undefined base by adding -4**10 per N into the rolling kmer
id (src/shared/Sequence.cpp:28-33) and later skips negative
``kmer % 4**(k+1)`` values (src/shared/BackgroundModel.cpp:73-81).  In C++
the remainder keeps the dividend's sign, so a window containing an N is
skipped *unless* the base-4 value contributed by its defined letters at
factors <= 4**k is exactly 0 — in which case it is counted as (k+1)-mer 0
(all-A).  An N counts toward nothing at factors, so e.g. at order 0 every
N is tallied as 'A'.  We reproduce: count value v when (no N within the
last min(i,8)+1 positions) or v == 0.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Sequence

import numpy as np

from ..utils.logging_utils import span, start_thread


class BackgroundModel:
    """Interpolated Markov background model (reference: BackgroundModel.cpp)."""

    def __init__(
        self,
        sequences: Optional[Sequence[np.ndarray]] = None,
        order: int = 2,
        alpha: Optional[Sequence[float]] = None,
        interpolate: bool = True,
        name: str = "",
        counts: Optional[List[np.ndarray]] = None,
        lazy: bool = False,
        defer: bool = False,
    ):
        """Build from encoded sequences (BaMM codes, 0 = N) or raw counts.

        Args:
          sequences: iterable of uint8 code arrays.
          order: Markov order K.
          alpha: per-order pseudocount weights; defaults to all 1.0
            (reference: src/Global.cpp:49).
          interpolate: smooth toward lower-order conditionals
            (reference: BackgroundModel.cpp:510-516).
          counts: pre-computed count vectors (e.g. psum'd across shards);
            overrides ``sequences``.
          lazy: count in a background thread; first access to ``n``/``v``
            joins it.  Lets the (k+1)-mer scan over the corpus overlap
            the device count dispatch (the reference's serial analogue:
            BackgroundModel.cpp:59-84 runs before Peng::process).
          defer: don't count at all — the device engine delivers counts via
            :meth:`provide_counts` (fused device histogram + host
            corrections).  If ``n``/``v`` are accessed before delivery
            (engine fallback, checkpoint path), counting runs
            synchronously on host.
        """
        self.order = order
        self.alpha = np.asarray(
            alpha if alpha is not None else np.ones(order + 1), dtype=np.float32
        )
        if self.alpha.shape[0] < order + 1:
            raise ValueError("alpha must have order+1 entries")
        self.interpolate = interpolate
        self.name = name

        self._count_thread = None
        self._defer_sequences = None
        if counts is not None:
            self._n = [np.asarray(c, dtype=np.int64) for c in counts]
            self._v = self._calculate_v()
        elif sequences is not None:
            if defer:
                self._n = self._v = None
                self._defer_sequences = sequences
            elif lazy:
                self._n = self._v = None

                def _run():
                    self._n = count_kmers(sequences, order)
                    self._v = self._calculate_v()

                self._count_thread = start_thread("bg_scan", _run)
            else:
                self._n = count_kmers(sequences, order)
                self._v = self._calculate_v()
        else:
            raise ValueError("either sequences or counts required")

    @property
    def deferred(self) -> bool:
        """True while this model is waiting for engine-delivered counts."""
        return self._defer_sequences is not None and self._n is None

    def provide_counts(self, counts: List[np.ndarray]):
        """Deliver externally computed (k+1)-mer count vectors (the device
        engine's fused device histogram + host corrections)."""
        self._n = [np.asarray(c, dtype=np.int64) for c in counts]
        self._v = self._calculate_v()
        self._defer_sequences = None

    def start_host_counting(self):
        """Deferred model, but the engine decided not to count on device
        (gate failed): begin the threaded host scan now so it overlaps
        the remaining dispatch work."""
        if not self.deferred:
            return
        sequences, order = self._defer_sequences, self.order
        self._defer_sequences = None

        def _run():
            self._n = count_kmers(sequences, order)
            self._v = self._calculate_v()

        self._count_thread = start_thread("bg_scan", _run)

    def _join(self):
        if self._count_thread is not None:
            with span("bg_wait"):
                self._count_thread.join()
            self._count_thread = None
        elif self.deferred:
            # accessed before the engine delivered: count synchronously
            sequences = self._defer_sequences
            self._defer_sequences = None
            with span("bg_scan"):
                self._n = count_kmers(sequences, self.order)
                self._v = self._calculate_v()

    @property
    def n(self) -> Optional[List[np.ndarray]]:
        self._join()
        return self._n

    @property
    def v(self) -> List[np.ndarray]:
        self._join()
        return self._v

    # -- counting & conditionals ------------------------------------------

    def _calculate_v(self) -> List[np.ndarray]:
        """Interpolated conditional probabilities
        (reference: BackgroundModel.cpp:490-530), float32 throughout with
        the reference's in-group summation order."""
        K = self.order
        n = self._n
        A = self.alpha
        v: List[np.ndarray] = []

        base_counts = np.float32(n[0].sum())
        v0 = (n[0].astype(np.float32) + A[0] * np.float32(0.25)) / (
            base_counts + A[0]
        )
        v.append(v0.astype(np.float32))

        for k in range(1, K + 1):
            nk = n[k].astype(np.float32)
            y = np.arange(4 ** (k + 1))
            y2 = y % (4 ** k)           # drop earliest letter
            yk = y // 4                 # drop latest letter
            if self.interpolate:
                vk = (nk + A[k] * v[k - 1][y2]) / (
                    n[k - 1].astype(np.float32)[yk] + A[k]
                )
            else:
                vk = (nk + A[k] * np.float32(0.25)) / (
                    n[k - 1].astype(np.float32)[yk] + A[k]
                )
            vk = vk.astype(np.float32)
            # per-context normalization over groups of 4 consecutive ids,
            # in the reference's sequential accumulation order
            g = vk.reshape(-1, 4)
            s = ((g[:, 0] + g[:, 1]) + g[:, 2]) + g[:, 3]
            vk = (g / s[:, None]).reshape(-1).astype(np.float32)
            v.append(vk)
        return v

    # -- BaMM file format -------------------------------------------------

    def write(self, directory: str) -> str:
        """Write conditional probabilities in BaMM format
        (reference: BackgroundModel.cpp:406-430).  Returns the file path."""
        suffix = ".hbcp" if self.interpolate else ".hnbcp"
        path = os.path.join(directory, (self.name or "bg") + suffix)
        with open(path, "w") as f:
            f.write(f"# K = {self.order}\n")
            f.write("# A =" + "".join(f" {a:g}" for a in
                                      self.alpha[: self.order + 1]) + "\n")
            for k in range(self.order + 1):
                f.write(" ".join(f"{x:.6e}" for x in self.v[k]) + "\n")
        return path

    @classmethod
    def read(cls, path: str) -> "BackgroundModel":
        """Read a BaMM .hbcp/.hnbcp file (reference:
        BackgroundModel.cpp:94-164): the conditionals only, no counts."""
        with open(path) as f:
            m = re.match(r"#\s*K\s*=\s*(\d+)", f.readline())
            if not m:
                raise ValueError(f"Wrong BaMM format: {path}")
            K = int(m.group(1))
            alphas = [float(x) for x in f.readline().split("=")[1].split()]
            v = []
            for k in range(K + 1):
                row = np.array([np.float32(x) for x in f.readline().split()],
                               dtype=np.float32)
                if row.shape[0] != 4 ** (k + 1):
                    raise ValueError(f"Wrong BaMM format: {path}")
                v.append(row)
        model = cls.__new__(cls)
        model.order = K
        model.alpha = np.asarray(alphas, dtype=np.float32)
        model.interpolate = path.endswith(".hbcp")
        model.name = os.path.basename(path).rsplit(".", 1)[0]
        model._count_thread = None
        model._defer_sequences = None
        model._n = None
        model._v = v
        return model


def count_kmers(sequences: Sequence[np.ndarray], order: int) -> List[np.ndarray]:
    """(k+1)-mer count vectors for k = 0..order with reference N-semantics
    (see module docstring; reference: BackgroundModel.cpp:59-84).
    Native scan for orders <= 8 (the reference's kmer ids cover no
    more); vectorized numpy over a padded batch above that."""
    sequences = list(sequences)
    if not sequences:
        return [np.zeros(4 ** (k + 1), dtype=np.int64)
                for k in range(order + 1)]
    from ..native import bg_count_kmers_native  # noqa: PLC0415

    native = bg_count_kmers_native(sequences, order)
    if native is not None:
        return native
    lengths = np.array([len(s) for s in sequences], dtype=np.int64)
    N, L = len(sequences), int(lengths.max())
    if L == 0:
        return [np.zeros(4 ** (k + 1), dtype=np.int64)
                for k in range(order + 1)]
    codes = np.zeros((N, L), dtype=np.int64)
    for i, s in enumerate(sequences):
        codes[i, : len(s)] = s

    # any_n9[b, i]: an N among in-sequence positions max(0, i-8)..i;
    # padding zeros never enter (positions >= length are masked out)
    is_n = codes == 0
    csum = np.concatenate(
        [np.zeros((N, 1), np.int64), np.cumsum(is_n, axis=1)], axis=1)
    idx = np.arange(L)
    lo = np.maximum(idx - 8, 0)
    any_n9 = (csum[:, idx + 1] - csum[:, lo]) > 0
    in_seq = idx[None, :] < lengths[:, None]

    counts = []
    v = np.zeros((N, L), dtype=np.int64)
    for k in range(order + 1):
        if k == 0:
            v = np.where(codes > 0, codes - 1, 0)
        elif k < L:
            shifted = np.zeros_like(codes)
            shifted[:, k:] = codes[:, :-k]
            v = v + np.where(shifted > 0, (shifted - 1) * (4 ** k), 0)
        ok = (idx[None, :] >= k) & in_seq & ((~any_n9) | (v == 0))
        counts.append(
            np.bincount(v[ok], minlength=4 ** (k + 1)).astype(np.int64))
    return counts


def bg_device_corrections(
    sequences: Sequence[np.ndarray],
    order: int,
    flat_codes: Optional[np.ndarray] = None,
    lengths: Optional[np.ndarray] = None,
) -> List[np.ndarray]:
    """Exact host completion of the fused device background histogram.

    The device counts a (k+1)-mer window ending at stream position t iff
    the 9 stream positions t-8..t are all non-zero
    (ops/stream_count.stream_bg_counts).  Relative to the reference rule
    — count iff (no N among in-sequence positions max(0,i-8)..i) or the
    window value is 0 (src/shared/BackgroundModel.cpp:73-81, N-sentinel
    quirk in Sequence.cpp:28-33) — the device misses exactly two
    disjoint classes, both returned here as additive count vectors:

    1. ends i <= 7 of every sequence with an N-free prefix 0..i (the
       stream lookback reaches the inter-sequence gap / chunk-0 zero
       padding, so the device never counts them);
    2. tainted windows whose value is 0 — an N within the lookback
       (so never device-counted) but every in-window defined letter
       is A (the reference's signed-modulo rescue counts these as
       all-A).

    Class 2 windows have an N inside positions 0..i, class 1 requires
    none — disjoint; everything with i >= 8 and a clean in-sequence
    lookback is counted identically by the device.  Cost: O(#sequences
    + #Ns), independent of corpus size.
    """
    counts = [np.zeros(4 ** (k + 1), dtype=np.int64)
              for k in range(order + 1)]
    n = len(sequences)
    if n == 0:
        return counts
    if lengths is None:
        lengths = np.array([len(s) for s in sequences], dtype=np.int64)
    else:
        lengths = np.asarray(lengths, dtype=np.int64)
    if flat_codes is None or flat_codes.shape[0] != int(lengths.sum()):
        flat_codes = np.concatenate(
            [np.asarray(s, dtype=np.uint8) for s in sequences]) \
            if int(lengths.sum()) else np.zeros(0, dtype=np.uint8)
    offsets = np.zeros(n, dtype=np.int64)
    offsets[1:] = np.cumsum(lengths[:-1])

    # --- class 1: clean-prefix ends i in [k, min(7, L-1)] --------------
    first8 = np.zeros((n, 8), dtype=np.int64)
    i_idx = np.arange(8)
    take = i_idx[None, :] < lengths[:, None]
    first8[take] = flat_codes[
        (offsets[:, None] + i_idx[None, :])[take]]
    clean = np.cumprod(first8 > 0, axis=1).astype(bool)
    nonneg = np.maximum(first8 - 1, 0)
    vk = np.zeros((n, 8), dtype=np.int64)
    for k in range(order + 1):
        if k == 0:
            vk = nonneg.copy()
        else:
            shifted = np.zeros((n, 8), dtype=np.int64)
            shifted[:, k:] = nonneg[:, : 8 - k]
            vk = vk + shifted * (4 ** k)
        mask = clean & take & (i_idx[None, :] >= k)
        if mask.any():
            counts[k] += np.bincount(vk[mask], minlength=4 ** (k + 1))

    # --- class 2: tainted all-A windows near real Ns -------------------
    n_flat = np.flatnonzero(flat_codes == 0)
    if n_flat.size:
        seq_of = np.searchsorted(offsets, n_flat, side="right") - 1
        pos_in = n_flat - offsets[seq_of]
        cand_seq = np.repeat(seq_of, 9)
        cand_end = (pos_in[:, None] + np.arange(9)[None, :]).reshape(-1)
        ok = cand_end < lengths[cand_seq]
        cand_seq, cand_end = cand_seq[ok], cand_end[ok]
        key = cand_seq * (int(lengths.max()) + 1) + cand_end
        uniq = np.unique(key)
        u_seq = uniq // (int(lengths.max()) + 1)
        u_end = uniq % (int(lengths.max()) + 1)
        for k in range(order + 1):
            sel = u_end >= k
            s, e = u_seq[sel], u_end[sel]
            all_a = np.ones(s.shape[0], dtype=bool)
            for j in range(k + 1):
                all_a &= flat_codes[offsets[s] + e - j] <= 1
            counts[k][0] += int(np.count_nonzero(all_a))
    return counts
