"""Seed selection and the hill climb of PEnG-motif, in plain NumPy and
PyTorch: which base patterns seed the search, what each climb makes of
its seed, and which candidates survive the filter.

Written from the upstream code (soedinglab/PEnG-motif:
base_pattern.cpp:252-265 and :443-515, peng.cpp:437-541 and :543-566,
iupac_alphabet.cpp:47-136, utils.h:10-37), with the statistics of
:mod:`.motifs`.  Nothing of the program under test is imported.

Upstream decides ties by order: the first of equal z-scores in its sort,
the first strict improvement of equal scores, the first of equal log p
in its sort.  Every pattern ties exactly with its reverse complement,
and other choices tie up to float32 rounding, which the program and
this reference sum in different orders.  So where two choices lie within
``TIE`` of each other (relative, and absolute below 1: a climb's score
is a difference of entropies of up to about 12, whose float32 rounding
does not shrink with it), the one the job printed is taken
(``follow``): the only decisions of the program the reference takes, and
only between choices it finds equal.  Everything else is decided here,
and the caller holds the job's printed seeds, climbs and candidates
against what comes out.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from . import motifs as M

F32 = np.float32
TIE = 1e-5

# the letters one climb step away from each (iupac_alphabet.cpp:47-136),
# in upstream's evaluation order
SIMILAR = {"A": "WRMN", "C": "SYMN", "G": "SRKN", "T": "WYKN",
           "S": "CGRYMKN", "W": "ATRYMKN", "R": "AGSWMKN", "Y": "CTSWMKN",
           "M": "ACSWRYN", "K": "GTSWRYN", "N": "ACGTSWRYMK"}
MI_PRIORS = (0.5, 0.1, 0.01)


def base_string(pid: int, W: int) -> str:
    return "".join("ACGT"[(pid >> (2 * p)) & 3] for p in range(W))


def base_id(pattern: str) -> int:
    return sum("ACGT".index(c) << (2 * p) for p, c in enumerate(pattern))


def zscores(counts: np.ndarray, expected: np.ndarray) -> np.ndarray:
    """z = (n - mu) / sqrt(mu): a float difference, a double division
    (base_pattern.cpp:252-265), as :func:`motifs.zscore` per pattern."""
    num = (counts.astype(F32) - expected.astype(F32)).astype(F32)
    return (num.astype(np.float64)
            / np.sqrt(expected.astype(F32).astype(np.float64))).astype(F32)


def _entropy(p: np.ndarray) -> np.ndarray:
    pd = np.asarray(p, dtype=F32).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        return (-pd * np.log(pd) - (1.0 - pd) * np.log(1.0 - pd)).astype(F32)


def mi_score(obs, expected, n_seq: int) -> np.ndarray:
    """The climb's score (utils.h:10-37, iupac_pattern.cpp:652-669): minus
    the sum over three priors of the mutual information of "holds a
    site" over its entropy; 0 where fewer sites are seen than expected.
    Float storage, double transcendentals."""
    o = np.asarray(obs).astype(F32)
    e = np.asarray(expected).astype(F32)
    n = F32(n_seq)
    p_obs = (1.0 - np.exp((-(o / n)).astype(np.float64))).astype(F32)
    p_exp = (1.0 - np.exp((-(e / n)).astype(np.float64))).astype(F32)
    h_obs, h_exp = _entropy(p_obs), _entropy(p_exp)
    score = np.zeros_like(o)
    for q in MI_PRIORS:
        q = F32(q)
        p = (p_obs * q).astype(F32) + (p_exp * (F32(1) - q)).astype(F32)
        mi = ((-q * h_obs) - ((F32(1) - q) * h_exp)) + _entropy(p)
        score = (score + mi / _entropy(np.array([q]))[0]).astype(F32)
    return np.where(o < e, F32(0), -score).astype(F32)


def _near(a, b, tie=TIE) -> bool:
    a, b = float(a), float(b)
    return (math.isfinite(a) and math.isfinite(b)
            and abs(a - b) <= tie * max(abs(a), abs(b), 1.0))


def order_following(keys: Sequence[float], rank: Sequence[float],
                    tie: float = TIE) -> List[int]:
    """Indices of ``keys`` in ascending order; a run of keys each within
    ``tie`` (relative) of the next is ordered by ``rank`` (the job's
    order; unranked last, in their own order)."""
    idx = sorted(range(len(keys)), key=lambda i: (keys[i], i))
    out, run = [], []
    for i in idx:
        if run and not _near(keys[run[-1]], keys[i], tie):
            out += sorted(run, key=lambda j: (rank[j], j))
            run = []
        run.append(i)
    return out + sorted(run, key=lambda j: (rank[j], j))


# -- the search --------------------------------------------------------------------


@dataclass
class Climb:
    """One seed's climb: the rows it accepted after the seed, and the
    pattern it emitted (None: removed)."""

    seed: str
    rows: List[str] = field(default_factory=list)
    emitted: Optional[str] = None


@dataclass
class Search:
    seeds: List[str]              # every selected seed, in order
    climbs: List[Climb]           # the first max_optimized seeds' climbs
    selected: List[str]           # the candidates the filter leaves


def select_seeds(t: M.Tables, z: np.ndarray, z_thr: float, count_thr: int,
                 follow: Sequence[str] = ()) -> List[str]:
    """base_pattern.cpp:443-515, both strands, neighbours filtered: walk
    the patterns in descending z until one falls below the threshold;
    skip those under the count threshold and those whose pattern or
    reverse complement is marked; take the rest, marking the pattern and
    each pattern one base from it.  ``follow``: the job's seeds, for ties
    only (the order within exact and float ties, and which of a pattern
    within ``TIE`` of the threshold takes part)."""
    W = t.W
    counts = t.counts.cpu().numpy()
    rc = t.rc.cpu().numpy()
    thr = F32(z_thr)
    near = np.flatnonzero(z >= thr - F32(TIE * abs(float(thr)) + 1e-30))
    printed = {base_id(s): k for k, s in enumerate(follow)}
    rank = {}
    for pid, k in printed.items():     # a pair's printed side first
        rank[pid] = (k, 0)
        rank.setdefault(int(rc[pid]), (k, 1))
    keep = [int(i) for i in near
            if z[i] >= thr or int(i) in rank]
    keep = [i for i in keep if not (_near(z[i], thr) and i not in rank)]
    ranks = [rank.get(i, (math.inf, 0)) for i in keep]
    order = order_following([-float(z[i]) for i in keep], ranks)
    seen = np.zeros(4 ** W, dtype=bool)
    out = []
    for k in order:
        pid = keep[k]
        if counts[pid] < count_thr or seen[pid] or seen[rc[pid]]:
            continue
        out.append(pid)
        for p in range(W):
            base = pid - (((pid >> (2 * p)) & 3) << (2 * p))
            seen[[base + (a << (2 * p)) for a in range(4)]] = True
    return [base_string(p, W) for p in out]


def climb(agg: M.Aggregates, seed: str, n_seq: int, seen: set, best_set: set,
          follow: Optional[Sequence[str]] = None) -> Climb:
    """peng.cpp:450-541 for one seed: score every pattern one letter from
    the current best, position by position in upstream's letter order,
    taking each strict improvement of the running best; stop when a step
    takes none or its best was seen before; emit the best unless it was
    seen or emitted.  ``follow``: the rows the job printed after this
    seed, for ties only."""
    (n, e, _), = agg([seed])
    best, best_score = seed, mi_score([n], [e], n_seq)[0]
    out = Climb(seed)
    improved = True
    while improved:
        improved = False
        mother = best
        cands = [mother[:p] + c + mother[p + 1:]
                 for p in range(len(mother)) for c in SIMILAR[mother[p]]]
        stats = agg(cands)
        scores = mi_score([s[0] for s in stats], [s[1] for s in stats],
                          n_seq)
        for cand, score in zip(cands, scores):
            take = bool(score < best_score)
            if follow is not None and _near(score, best_score):
                k = len(out.rows)
                take = k < len(follow) and follow[k] == cand
            if take:
                improved, best, best_score = True, cand, score
                out.rows.append(cand)
        if best in seen:
            improved = False
        seen.update(c for c in cands if c != best)
    if best not in best_set and best not in seen:
        best_set.add(best)
        seen.add(best)
        out.emitted = best
    return out


def informative(pattern: str) -> int:
    return sum(c != "N" for c in pattern)


def search(t: M.Tables, agg: M.Aggregates, n_seq: int, z_thr: float,
           count_thr: int, max_optimized: int,
           job: Optional[dict] = None) -> Search:
    """Seeds, climbs and the filtered candidates (peng.cpp:543-566: more
    than three informative positions; by log p; kept below min(-5, a
    fifth of the best log p)).  ``job``: what a job printed
    (:func:`bench_port.compare.parse_stdout`), for ties only."""
    job = job or {}
    expected = t.expected.cpu().numpy()
    z = zscores(t.counts.cpu().numpy(), expected)
    seeds = select_seeds(t, z, z_thr, count_thr,
                         [s[0] for s in job.get("seeds", ())])
    blocks = {b["seed"]: [r[0] for r in b["rows"]]
              for b in job.get("climbs", ())}
    seen, best_set = set(), set()
    climbs = [climb(agg, s, n_seq, seen, best_set, blocks.get(s))
              for s in seeds[:max_optimized]]
    found = [c.emitted for c in climbs
             if c.emitted and informative(c.emitted) > 3]
    logp = []
    for pat, (n, mu, _) in zip(found, agg(found)):
        logp.append(M.iupac_log_pvalue(n, mu, M.zscore(n, mu), pat))
    printed = {p: k for k, p in enumerate(job.get("selected", ()))}
    order = order_following([float(v) for v in logp],
                            [printed.get(p, math.inf) for p in found])
    found, logp = [found[k] for k in order], [logp[k] for k in order]
    cut = min(F32(-5.0), F32(logp[0] * F32(0.2))) if logp else F32(-5.0)
    selected = [p for p, v in zip(found, logp)
                if v < cut or (_near(v, cut) and p in printed)]
    return Search(seeds, climbs, selected)
