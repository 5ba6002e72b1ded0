"""FASTA parsing into encoded sequence arrays.

Mirrors reference: src/shared/SequenceSet.cpp:285-447 semantics (header
handling, blank lines, empty-entry warnings, space-in-sequence error,
base-frequency accumulation over defined bases only).  A native C++
fast-path parser lives in native/ (pengnative.cpp); this module is the
semantics oracle and serves the inputs the native parser declines.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..alphabets import Alphabet, STANDARD


class FastaFormatError(RuntimeError):
    pass


@dataclass
class SequenceSet:
    """Encoded FASTA sequence set (reference: src/shared/SequenceSet.{h,cpp}).

    sequences hold BaMM codes (0 = undefined/N, 1..4 = ACGT).
    """

    filepath: str
    sequences: List[np.ndarray] = field(default_factory=list)
    headers: List[str] = field(default_factory=list)
    base_frequencies: Optional[np.ndarray] = None
    # undefined (N) bases in the whole set; None = not tracked by this
    # construction path (engine then falls back to a corpus scan)
    n_undefined: Optional[int] = None
    alphabet: Alphabet = STANDARD
    # parse warnings, recorded so a reused parse can replay them (the
    # reference re-parses the input for the background set and emits
    # every warning twice, src/Global.cpp:58-75)
    warnings: List[str] = field(default_factory=list)

    @property
    def n(self) -> int:
        return len(self.sequences)

    def _lengths(self) -> np.ndarray:
        cached = getattr(self, "_lengths_cache", None)
        if cached is None or cached.shape[0] != len(self.sequences):
            cached = np.array([len(s) for s in self.sequences], dtype=np.int64)
            object.__setattr__(self, "_lengths_cache", cached)
        return cached

    @property
    def max_l(self) -> int:
        lengths = self._lengths()
        return int(lengths.max()) if lengths.size else 0

    @property
    def total_bases(self) -> int:
        return int(self._lengths().sum())

    def padded(self, pad_multiple: int = 128) -> np.ndarray:
        """[N, Lmax'] uint8 batch, zero-padded (pad == undefined base, which
        window validity treats exactly like the reference's sequence end)."""
        max_l = self.max_l
        if pad_multiple > 1:
            max_l = ((max_l + pad_multiple - 1) // pad_multiple) * pad_multiple
        out = np.zeros((self.n, max_l), dtype=np.uint8)
        flat = getattr(self, "_flat_codes", None)
        if flat is not None and flat.shape[0] == self.total_bases:
            # vectorized fill from the contiguous parse buffer: the
            # row-major mask enumerates exactly the concatenation order
            lengths = self._lengths()
            mask = np.arange(max_l)[None, :] < lengths[:, None]
            out[mask] = flat
            return out
        for i, s in enumerate(self.sequences):
            out[i, : len(s)] = s
        return out


def read_fasta(
    filepath: str,
    alphabet: Alphabet = STANDARD,
    warn_stream=sys.stderr,
) -> SequenceSet:
    """Parse a FASTA file (reference: SequenceSet.cpp:285-447)."""
    sset = SequenceSet(filepath=filepath, alphabet=alphabet)
    base_counts = np.zeros(alphabet.size, dtype=np.int64)

    header: Optional[str] = None
    chunks: List[str] = []

    def warn(msg: str):
        sset.warnings.append(msg)
        print(msg, file=warn_stream)

    def flush(final: bool = False):
        nonlocal header, chunks
        if header is None:
            return
        seq = "".join(chunks)
        if not seq:
            warn(f"Warning: Ignore FASTA entry without sequence: {filepath}")
            header = None
            chunks = []
            return
        codes = alphabet.encode(seq)
        if final:
            # reference quirk: only the EOF-flushed (last) entry warns
            # per undefined base (SequenceSet.cpp:395-404; the mid-file
            # flush at :333 excludes silently)
            for ch, code in zip(seq, codes.tolist()):
                if code == 0:
                    warn("Warning: The FASTA file contains an undefined "
                         f"base: {ch} at sequence {header}")
        np.add.at(base_counts, codes[codes > 0] - 1, 1)
        sset.sequences.append(codes)
        sset.headers.append(header)
        header = None
        chunks = []

    # an unreadable file propagates as FileNotFoundError/OSError; the CLI
    # renders the reference's message + exit(1)
    # (reference: SequenceSet.cpp:445-448)
    with open(filepath) as f:
        content = f.read()
    lines = content.split("\n")
    # Reference quirk, reproduced: getline(...).good() discards a final
    # line that is not newline-terminated (reference:
    # SequenceSet.cpp:304 — the while condition fails on EOF *after* the
    # unterminated line is extracted, so it is never processed).
    if not content.endswith("\n"):
        lines = lines[:-1]

    if True:
        for line in lines:
            line = line.rstrip("\r")
            if not line:
                continue
            if line[0] == ">":
                flush()
                header = line[1:] if len(line) > 1 else str(len(sset.sequences) + 1)
            elif header is not None:
                if " " in line:
                    raise FastaFormatError(
                        f"FASTA sequence contains space character: {filepath}"
                    )
                chunks.append(line)
            else:
                raise FastaFormatError(f"Wrong FASTA format: {filepath}")
        flush(final=True)

    total = base_counts.sum()
    sset.base_frequencies = (
        base_counts.astype(np.float32) / np.float32(total) if total else
        np.zeros(alphabet.size, dtype=np.float32)
    )
    # O(1) undefined-base count for the engine's mass-N gate (same
    # contract as the native parser's sset.n_undefined)
    sset.n_undefined = sset.total_bases - int(total)
    return sset


def _walk_fasta_records(filepath: str):
    """Yield per-record lists of sequence-line strings with exactly the
    quirks of :func:`read_fasta` (unterminated-final-line drop, \\r
    strip, blank-line skip, empty-entry skip, space error).  Records
    that :func:`read_fasta` ignores (no sequence) are not yielded, so
    indices align with ``SequenceSet.sequences``."""
    with open(filepath) as f:
        content = f.read()
    lines = content.split("\n")
    if not content.endswith("\n"):
        lines = lines[:-1]
    header_seen = False
    chunks: List[str] = []
    for line in lines:
        line = line.rstrip("\r")
        if not line:
            continue
        if line[0] == ">":
            if header_seen and chunks:
                yield chunks
            header_seen = True
            chunks = []
        elif header_seen:
            if " " in line:
                raise FastaFormatError(
                    f"FASTA sequence contains space character: {filepath}")
            chunks.append(line)
        else:
            raise FastaFormatError(f"Wrong FASTA format: {filepath}")
    if header_seen and chunks:
        yield chunks


def read_fasta_lengths(filepath: str) -> np.ndarray:
    """Sequence lengths only — no encoding, no warnings.  For the worker
    processes of a multi-process count, which need the global stream
    layout (all lengths) but only their own shard's bases; lengths here
    are identical to a full :func:`read_fasta`."""
    return np.array([sum(len(c) for c in chunks)
                     for chunks in _walk_fasta_records(filepath)],
                    dtype=np.int64)


def read_fasta_ranges(filepath: str, spans, alphabet: Alphabet = STANDARD):
    """Decode only the records whose index falls in one of ``spans``
    (half-open [a, b) pairs).  Returns {index: codes}.  Encoding is the
    same LUT as :func:`read_fasta`; warnings are not emitted (worker
    processes never print)."""
    want = sorted((int(a), int(b)) for a, b in spans)
    out = {}
    for i, chunks in enumerate(_walk_fasta_records(filepath)):
        if any(a <= i < b for a, b in want):
            out[i] = alphabet.encode("".join(chunks))
    return out


def load_sequence_set(filepath: str, alphabet: Alphabet = STANDARD) -> SequenceSet:
    """Load via the native C++ parser; the pure-Python parser serves
    what the native one declines (non-standard alphabets, unreadable
    files, whose OSError it then raises)."""
    from ..native import parse_fasta_native  # noqa: PLC0415

    result = parse_fasta_native(filepath, alphabet)
    if result is not None:
        return result
    return read_fasta(filepath, alphabet)
