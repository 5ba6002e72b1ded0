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


def entropy_f(p: np.float32) -> np.float32:
    """-p*log(p) - (1-p)*log(1-p), double internally, float32 result
    (reference: src/utils.h:25-27)."""
    pd = float(p)
    return F32(-pd * math.log(pd) - (1.0 - pd) * math.log(1.0 - pd))


def mutual_information_fast(
    observed: float, expected: float, n_sequences: int, prior: float
) -> np.float32:
    """reference: src/utils.h:29-37 (calculate_mutual_information_fast)."""
    obs = F32(observed)
    exp_ = F32(expected)
    n = F32(n_sequences)
    p_obs = F32(1.0 - math.exp(float(F32(-(obs / n)))))
    p_exp = F32(1.0 - math.exp(float(F32(-(exp_ / n)))))
    q = F32(prior)
    p = F32(F32(p_obs * q) + F32(p_exp * F32(F32(1.0) - q)))
    h = entropy_f
    return F32(F32(-q * h(p_obs)) - F32(F32(F32(1.0) - q) * h(p_exp)) + h(p))


def mutual_information_score(
    observed: float, expected: float, n_sequences: int
) -> np.float32:
    """Sum of MI/H over priors {0.5, 0.1, 0.01}, negated for minimization
    (reference: src/base_pattern.cpp:184-200,
    src/iupac_pattern.cpp:652-669).  Returns 0 when observed < expected."""
    if F32(observed) < F32(expected):
        return F32(0.0)
    score = F32(0.0)
    for q in (0.5, 0.1, 0.01):
        score = F32(
            score
            + F32(
                mutual_information_fast(observed, expected, n_sequences, q)
                / entropy_f(F32(q))
            )
        )
    return F32(-score)


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


def exp_count_fraction(
    observed: float, expected: np.float32, pseudo_expected: int
) -> np.float32:
    """(expected + pseudo) / observed (reference: src/base_pattern.cpp:180-182,
    src/iupac_pattern.cpp:648-650)."""
    return F32(F32(F32(expected) + F32(pseudo_expected)) / F32(observed))


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
