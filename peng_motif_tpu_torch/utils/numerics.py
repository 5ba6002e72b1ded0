"""Scalar score functions with C++-faithful float32/float64 mixing.

The reference computes its optimization scores in float variables but
with C-library math promoted to double (reference: src/utils.h:10-37,
src/iupac_pattern.cpp:446-469).  Decision points (strict < comparisons in
the hill climb) can flip on last-ulp differences, so these helpers mirror
the C++ promotion/rounding points: every intermediate that C++ stores in
a ``float`` is rounded to float32 here.
"""

from __future__ import annotations

import math

import numpy as np

F32 = np.float32


def iupac_log_pvalue(
    n_sites: int,
    expected: np.float32,
    zscore: np.float32,
    iupac_digits,
    log_bonferroni: np.ndarray,
) -> np.float32:
    """Per-IUPAC-pattern log p-value with Bonferroni letter penalties
    (reference: src/iupac_pattern.cpp:453-469)."""
    if n_sites == 0:
        return F32(np.inf)
    mu = F32(expected)
    # 1 - mu/(n_sites+1): all-float32 expression in the reference
    frac = F32(F32(1.0) - F32(mu / F32(n_sites + 1)))
    logp = 0.0
    if F32(n_sites) > mu and n_sites > 5 and zscore > 2:
        ns = float(n_sites)
        # mu/n_sites divides in float32 before the double-precision log
        # (size_t converts to float in the C++ expression)
        ratio = F32(mu / F32(n_sites))
        logp = (
            ns * math.log(float(ratio))
            + ns
            - float(mu)
            - 0.5 * math.log(6.283 * ns * float(frac) * float(frac))
        )
    logp = F32(logp)
    for c in iupac_digits:
        logp = F32(logp + log_bonferroni[int(c)])
    return logp


def zscore_from_sums(sum_counts: int, sum_expected: np.float32) -> np.float32:
    """(observed - expected) / sqrt(expected)
    (reference: src/iupac_pattern.cpp:446).  The numerator is a float
    subtraction; sqrt promotes to double, so the division is double."""
    num = F32(F32(sum_counts) - F32(sum_expected))
    return F32(float(num) / math.sqrt(float(F32(sum_expected))))


def pwm_info_content(pwm: np.ndarray) -> float:
    """Average-information display metric (reference: src/utils.h:52-63)."""
    total = F32(0.0)
    length, n_states = pwm.shape
    for pos in range(length):
        for a in range(n_states):
            p = F32(pwm[pos][a])
            if p != 0:
                total = F32(total + float(p) * math.log2(float(p)))
    return F32(total + length * math.log2(n_states))


def no_zero_pwm(pwm: np.ndarray, precision: int = 8) -> np.ndarray:
    """Add a normalization-preserving epsilon so no entry prints as zero,
    in place (reference: src/utils.h:40-49).  Returns the same array."""
    delta = F32(10.0 ** (-precision))
    epsilon = F32(delta / F32(F32(1.0) - F32(4.0) * delta))
    pwm += epsilon
    normalize_pwm(pwm)
    return pwm


def normalize_pwm(pwm: np.ndarray) -> np.ndarray:
    """Row-normalize in float32, in place
    (reference: src/iupac_pattern.cpp:291-303)."""
    for pos in range(pwm.shape[0]):
        row = pwm[pos]
        s = F32(F32(F32(row[0] + row[1]) + row[2]) + row[3])
        pwm[pos] = (row / s).astype(F32)
    return pwm


def cpp_float(x: float) -> str:
    """Format like C++ default ostream for float/double (6 significant
    digits, %g-style trailing-zero stripping)."""
    if isinstance(x, (np.floating,)):
        x = float(x)
    if math.isinf(x):
        return "inf" if x > 0 else "-inf"
    if math.isnan(x):
        return "nan"
    return f"{x:.6g}"
