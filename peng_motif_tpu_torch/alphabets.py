"""DNA and IUPAC alphabets, encodings, and pattern-id arithmetic.

Semantics mirror the reference implementation's alphabet layer
(reference: src/shared/Alphabet.cpp:10-46, src/iupac_alphabet.{h,cpp}),
re-expressed as plain tables + numpy helpers.  Two encodings coexist:

* BaMM codes:  0 = 'other'/N, 1..size = alphabet letters (used for raw
  sequences, reference: src/shared/Alphabet.cpp:36-41).
* PEnG codes:  0..3 = A,C,G,T (used inside pattern ids; PEnG code =
  BaMM code - 1, reference: src/base_pattern.h:20-29).

Pattern ids are little-endian positional encodings: position p carries
factor ``alphabet_size ** p`` (reference: src/base_pattern.cpp:98-107 for
base-4 ids, src/iupac_pattern.cpp:192-197 for base-11 IUPAC ids).
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# DNA alphabets (reference: src/shared/Alphabet.cpp:10-31)
# ---------------------------------------------------------------------------

_ALPHABET_DEFS = {
    "STANDARD": "ACGT",
    "METHYLC": "ACGTM",
    "HYDROXYMETHYLC": "ACGTH",
    "EXTENDED": "ACGTMH",
}


class Alphabet:
    """DNA alphabet with BaMM-style encodings (code 0 = undefined/N).

    The reference keeps this as process-global state; here it is a small
    immutable object.  Only STANDARD is accepted by the motif pipeline
    (the reference CLI hardcodes STANDARD, src/Global.cpp:312-313), but
    all four reference alphabet types construct for API parity.
    """

    def __init__(self, alphabet_type: str = "STANDARD"):
        if alphabet_type not in _ALPHABET_DEFS:
            raise ValueError(
                "alphabet type must be STANDARD, METHYLC, HYDROXYMETHYLC, "
                f"or EXTENDED (got {alphabet_type!r})"
            )
        self.alphabet_type = alphabet_type
        self.alphabet = _ALPHABET_DEFS[alphabet_type]
        self.size = len(self.alphabet)

        # base char -> code (1-based; 0 for anything undefined), case-insensitive
        self._base_to_code = np.zeros(128, dtype=np.uint8)
        for i, ch in enumerate(self.alphabet):
            self._base_to_code[ord(ch)] = i + 1
            self._base_to_code[ord(ch.lower())] = i + 1

    def encode(self, sequence: str) -> np.ndarray:
        """Encode a string into BaMM codes (uint8; 0 for undefined bases)."""
        raw = np.frombuffer(sequence.encode("latin-1"), dtype=np.uint8)
        return self._base_to_code[np.where(raw < 128, raw, 0)]


STANDARD = Alphabet("STANDARD")

# ---------------------------------------------------------------------------
# IUPAC alphabet (reference: src/iupac_alphabet.h:15-16)
# ---------------------------------------------------------------------------

IUPAC_ALPHABET_SIZE = 11
IUPAC_A, IUPAC_C, IUPAC_G, IUPAC_T = 0, 1, 2, 3
IUPAC_S, IUPAC_W, IUPAC_R, IUPAC_Y = 4, 5, 6, 7
IUPAC_M, IUPAC_K, IUPAC_N = 8, 9, 10

IUPAC_CHARS = "ACGTSWRYMKN"

# Hill-climb move table: letters considered "similar" to each letter
# (reference: src/iupac_alphabet.cpp:47-136).  Order matters: the greedy
# optimizer evaluates candidates in this order.
IUPAC_SIMILAR = (
    (IUPAC_W, IUPAC_R, IUPAC_M, IUPAC_N),                                      # A
    (IUPAC_S, IUPAC_Y, IUPAC_M, IUPAC_N),                                      # C
    (IUPAC_S, IUPAC_R, IUPAC_K, IUPAC_N),                                      # G
    (IUPAC_W, IUPAC_Y, IUPAC_K, IUPAC_N),                                      # T
    (IUPAC_C, IUPAC_G, IUPAC_R, IUPAC_Y, IUPAC_M, IUPAC_K, IUPAC_N),           # S
    (IUPAC_A, IUPAC_T, IUPAC_R, IUPAC_Y, IUPAC_M, IUPAC_K, IUPAC_N),           # W
    (IUPAC_A, IUPAC_G, IUPAC_S, IUPAC_W, IUPAC_M, IUPAC_K, IUPAC_N),           # R
    (IUPAC_C, IUPAC_T, IUPAC_S, IUPAC_W, IUPAC_M, IUPAC_K, IUPAC_N),           # Y
    (IUPAC_A, IUPAC_C, IUPAC_S, IUPAC_W, IUPAC_R, IUPAC_Y, IUPAC_N),           # M
    (IUPAC_G, IUPAC_T, IUPAC_S, IUPAC_W, IUPAC_R, IUPAC_Y, IUPAC_N),           # K
    (IUPAC_A, IUPAC_C, IUPAC_G, IUPAC_T, IUPAC_S, IUPAC_W, IUPAC_R, IUPAC_Y,
     IUPAC_M, IUPAC_K),                                                        # N
)

# Expansion table: base letters represented by each IUPAC letter
# (reference: src/iupac_alphabet.cpp:138-180).
IUPAC_REPRESENTATIVE = (
    (IUPAC_A,), (IUPAC_C,), (IUPAC_G,), (IUPAC_T,),
    (IUPAC_C, IUPAC_G),     # S
    (IUPAC_A, IUPAC_T),     # W
    (IUPAC_A, IUPAC_G),     # R
    (IUPAC_C, IUPAC_T),     # Y
    (IUPAC_A, IUPAC_C),     # M
    (IUPAC_G, IUPAC_T),     # K
    (IUPAC_A, IUPAC_C, IUPAC_G, IUPAC_T),  # N
)

# [11, 4] 0/1 matrix: row c marks which ACGT bases IUPAC letter c matches.
IUPAC_MASKS = np.zeros((IUPAC_ALPHABET_SIZE, 4), dtype=np.int32)
for _c, _reps in enumerate(IUPAC_REPRESENTATIVE):
    for _r in _reps:
        IUPAC_MASKS[_c, _r] = 1

# Multiple-testing penalty per IUPAC letter added to IUPAC log p-values
# (reference: src/iupac_pattern.cpp:199-210).
LOG_BONFERRONI = np.array(
    [np.log(8)] * 4 + [np.log(16)] * 4 + [np.log(24)] * 2 + [np.log(6)],
    dtype=np.float32,
)

# ---------------------------------------------------------------------------
# Pattern-id arithmetic (little-endian positional encodings)
# ---------------------------------------------------------------------------


def base_id_to_digits(pattern_id: int, length: int) -> np.ndarray:
    """PEnG base-4 id -> per-position codes, position 0 first."""
    digits = np.empty(length, dtype=np.int64)
    for p in range(length):
        digits[p] = pattern_id % 4
        pattern_id //= 4
    return digits


def base_id_to_string(pattern_id: int, length: int) -> str:
    """Mirror of BasePattern::toString (reference: src/base_pattern.cpp:109-117)."""
    return "".join("ACGT"[c] for c in base_id_to_digits(pattern_id, length))


def iupac_id_to_digits(pattern_id: int, length: int) -> np.ndarray:
    digits = np.empty(length, dtype=np.int64)
    for p in range(length):
        digits[p] = pattern_id % IUPAC_ALPHABET_SIZE
        pattern_id //= IUPAC_ALPHABET_SIZE
    return digits


def digits_to_iupac_id(digits) -> int:
    out = 0
    for p, c in enumerate(digits):
        out += int(c) * (IUPAC_ALPHABET_SIZE ** p)
    return out


def iupac_id_to_string(pattern_id: int, length: int) -> str:
    """Mirror of IUPACPattern::toString (reference: src/iupac_pattern.cpp:306-314)."""
    return "".join(IUPAC_CHARS[c] for c in iupac_id_to_digits(pattern_id, length))


def base_id_to_iupac_id(pattern_id: int, length: int) -> int:
    """Map a base-4 id onto the IUPAC id of the same literal pattern
    (reference: src/base_pattern.cpp:170-178)."""
    return digits_to_iupac_id(base_id_to_digits(pattern_id, length))
