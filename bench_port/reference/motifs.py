"""The motif stages of PEnG-motif after the hill climb, in plain PyTorch:
the background model, the candidates' statistics, the advanced PWMs,
EM, merging, the redundancy filter and the MEME ordering.

Written from the upstream formulas (soedinglab/PEnG-motif:
BackgroundModel.cpp:490-530, base_pattern.cpp:252-325,
iupac_pattern.cpp:75-303 and :410-718, peng.cpp:48-310, utils.h:40-49)
in float32 where upstream computes in float, with float64 where upstream
promotes to double.  Nothing of the program under test is imported.

It starts from the candidates that the reference's own seed selection
and climb keep (:mod:`.climb`).  Between merge choices that tie within
rounding it takes the program's (:func:`merge_all`).

``control=True`` computes every contraction from TF32-rounded inputs
(10 mantissa bits, float32 sums), which is what the card does with TF32
switched on, and sums counts in float32 where upstream's port states a
float64 chain: the precision below the stated one.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

F32 = np.float32

# IUPAC letters: the bases each stands for, and upstream's multiple-
# testing penalty per letter (iupac_pattern.cpp:199-210)
IUPAC = {"A": "A", "C": "C", "G": "G", "T": "T", "S": "CG", "W": "AT",
         "R": "AG", "Y": "CT", "M": "AC", "K": "GT", "N": "ACGT"}
IUPAC_ORDER = "ACGTSWRYMKN"   # upstream's letter order (first minimum wins)
BONFERRONI = {c: F32(math.log(v)) for c, v in zip(
    IUPAC_ORDER, (8, 8, 8, 8, 16, 16, 16, 16, 24, 24, 6))}
MIXIN_FACTOR, MIXIN_BIAS = F32(0.2), F32(0.7)
MIN_MERGE_OVERLAP = 6


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits, nearest even)."""
    i = x.to(torch.float32).contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    i = (i + 0x0FFF + lsb) & ~0x1FFF
    return i.view(torch.float32)


def mask_rows(pattern: str) -> np.ndarray:
    """[W, 4] 0/1 rows of an IUPAC pattern."""
    return np.array([[1.0 if b in IUPAC[c] else 0.0 for b in "ACGT"]
                     for c in pattern], dtype=np.float32)


def _outer(rows: torch.Tensor) -> torch.Tensor:
    """[4**W] prod_p rows[p][digit_p(id)], id little-endian, multiplied
    from position 0 up (each step: the running product times the next
    position's factor, in the tensor's dtype)."""
    out = torch.ones(1, dtype=rows.dtype, device=rows.device)
    for p in range(rows.shape[0]):
        out = (rows[p].reshape(4, 1) * out.reshape(1, -1)).reshape(-1)
    return out


def _marginals(table: torch.Tensor, W: int) -> torch.Tensor:
    """[W, 4]: for each position p and base a, the sum of ``table`` over
    the ids whose digit p is a."""
    return torch.stack([table.reshape(4 ** (W - 1 - p), 4, 4 ** p)
                        .sum(dim=(0, 2)) for p in range(W)])


def revcomp_perm(W: int, device) -> torch.Tensor:
    ids = torch.arange(4 ** W, device=device, dtype=torch.int64)
    rc = torch.zeros_like(ids)
    for p in range(W):
        rc += (3 - ((ids >> (2 * p)) & 3)) << (2 * (W - 1 - p))
    return rc


def conditionals(counts: Sequence[np.ndarray]) -> List[np.ndarray]:
    """The interpolated Markov background (alpha 1 at every order):
    v0 = (n0 + 1/4) / (N + 1); v_k(y) = (n_k(y) + v_{k-1}(y without its
    earliest base)) / (n_{k-1}(context) + 1), each context's four
    values then normalised, float32."""
    v = []
    n0 = counts[0].astype(F32)
    v.append(((n0 + F32(0.25)) / (F32(counts[0].sum()) + F32(1))).astype(F32))
    for k in range(1, len(counts)):
        y = np.arange(4 ** (k + 1))
        vk = ((counts[k].astype(F32) + v[k - 1][y % 4 ** k])
              / (counts[k - 1].astype(F32)[y // 4] + F32(1))).astype(F32)
        g = vk.reshape(-1, 4)
        s = ((g[:, 0] + g[:, 1]) + g[:, 2]) + g[:, 3]
        v.append((g / s[:, None]).reshape(-1).astype(F32))
    return v


def bg_prob(v: Sequence[np.ndarray], W: int, order: int,
            device) -> torch.Tensor:
    """[4**W] float32 background probability of each pattern: the product
    over positions, left to right, of the conditional of each base given
    up to ``order`` bases before it."""
    ids = torch.arange(4 ** W, device=device, dtype=torch.int64)
    p = torch.ones(4 ** W, dtype=torch.float32, device=device)
    for pos in range(W):
        k = min(pos, order)
        ctx = torch.zeros_like(ids)
        for j in range(k + 1):          # big-endian: earliest base first
            ctx = ctx * 4 + ((ids >> (2 * (pos - k + j))) & 3)
        p = p * torch.from_numpy(v[k]).to(device)[ctx]
    return p


@dataclass
class Tables:
    """What the motif stages read: the count table and the background."""

    W: int
    counts: torch.Tensor          # [4**W] int64, mirrored
    ltot: int
    v: List[np.ndarray]           # conditionals, orders 0..K
    order_k: int                  # order of the z-scores (2, or W-1)
    rc: torch.Tensor = field(init=False)
    bgp: torch.Tensor = field(init=False)
    expected: torch.Tensor = field(init=False)

    def __post_init__(self):
        dev = self.counts.device
        self.rc = revcomp_perm(self.W, dev)
        p = bg_prob(self.v, self.W, self.order_k, dev)
        ids = torch.arange(4 ** self.W, device=dev)
        # both strands: a pattern's probability plus its reverse
        # complement's, a palindrome's once
        self.bgp = torch.where(ids == self.rc, p, p + p[self.rc])
        self.expected = self.bgp * float(F32(self.ltot))


def zscore(n: int, mu) -> np.float32:
    num = F32(F32(n) - F32(mu))
    return F32(float(num) / math.sqrt(float(F32(mu))))


def iupac_log_pvalue(n: int, mu, z, pattern: str) -> np.float32:
    """upstream iupac_pattern.cpp:453-469: the Poisson tail term (float
    operands, double logarithms) plus the letters' penalties."""
    if n == 0:
        return F32(np.inf)
    mu = F32(mu)
    frac = F32(F32(1) - F32(mu / F32(n + 1)))
    logp = 0.0
    if F32(n) > mu and n > 5 and z > 2:
        ratio = F32(mu / F32(n))
        logp = (n * math.log(float(ratio)) + n - float(mu)
                - 0.5 * math.log(6.283 * n * float(frac) * float(frac)))
    logp = F32(logp)
    for c in pattern:
        logp = F32(logp + BONFERRONI[c])
    return logp


class Aggregates:
    """(count, expected, background probability) of IUPAC patterns: sums
    over the canonical pairs of which either orientation matches a
    pattern (iupac_pattern.cpp:410-441), in float64, a batch of patterns
    at a time on the tables' device, kept by pattern."""

    def __init__(self, t: Tables, chunk: Optional[int] = None):
        self.t, self.memo = t, {}
        canon = torch.arange(4 ** t.W, device=t.counts.device) <= t.rc
        self.vals = torch.stack([t.counts.to(torch.float64),
                                 t.expected.to(torch.float64),
                                 t.bgp.to(torch.float64)], 1)
        self.vals[~canon] = 0
        self.chunk = chunk or max(1, min(64, 2 ** 27 // 4 ** t.W))

    @staticmethod
    def _outer(rows: torch.Tensor) -> torch.Tensor:
        """[B, 4**W] bool: does each id match each pattern (little-endian
        ids, position 0 the lowest digit)."""
        out = torch.ones(rows.shape[0], 1, dtype=torch.bool,
                         device=rows.device)
        for p in range(rows.shape[1]):
            out = (rows[:, p, :, None] & out[:, None, :]).reshape(
                rows.shape[0], -1)
        return out

    def __call__(self, patterns: Sequence[str]):
        todo = [p for p in dict.fromkeys(patterns) if p not in self.memo]
        dev = self.vals.device
        for i in range(0, len(todo), self.chunk):
            part = todo[i:i + self.chunk]
            rows = torch.from_numpy(np.stack(
                [mask_rows(p) for p in part]) > 0).to(dev)
            # a canonical id counts when it, or its reverse complement,
            # matches the pattern
            m = self._outer(rows) | self._outer(rows.flip(1).flip(2))
            res = (m.to(torch.float64) @ self.vals).cpu().numpy()
            for p, (n, e, b) in zip(part, res):
                self.memo[p] = (int(round(n)), F32(e), F32(b))
        return [self.memo[p] for p in patterns]


def adv_pwm(t: Tables, pattern: str, pseudo: int,
            control: bool = False) -> np.ndarray:
    """upstream iupac_pattern.cpp:505-536: for each position p and base
    a, the count of the pattern with p replaced by a, over the canonical
    pairs that match in either orientation; plus trunc(bg0 * pseudo);
    divided by the row total (integers, a double division, float cells).
    """
    W, dev = t.W, t.counts.device
    ids = torch.arange(4 ** W, device=dev)
    canon = torch.where(ids <= t.rc, t.counts, torch.zeros_like(t.counts))
    if control:
        weights, acc = tf32(canon.to(torch.float32)), torch.float32
    else:
        weights, acc = canon.to(torch.float64), torch.float64
    rows = torch.from_numpy(mask_rows(pattern)).to(dev, acc)
    sub = np.zeros((W, 4))
    for p in range(W):
        for a in range(4):
            r = rows.clone()
            r[p] = 0
            r[p, a] = 1
            m = _outer(r)
            sub[p, a] = float((weights * torch.maximum(m, m[t.rc])).sum())
    base = np.trunc(t.v[0].astype(F32) * F32(pseudo)).astype(np.int64)
    total = base[None, :] + np.round(sub).astype(np.int64)
    return (total / total.sum(axis=1, keepdims=True)).astype(F32)


def em(pwm: np.ndarray, t: Tables, bg_max: torch.Tensor, saturation: float,
       min_change: float, max_iter: int, control: bool = False):
    """upstream peng.cpp:48-197 for one motif over the whole table:
    odds = prod pwm / bg; r = count * s / (1 + s / odds); the new PWM is
    r's per-position marginal, rows normalised; it iterates while the L1
    change exceeds ``min_change``, at most ``max_iter`` times.
    Returns (pwm [W, 4] float32, iterations)."""
    W, dev = t.W, t.counts.device
    s = torch.tensor(saturation, dtype=torch.float32, device=dev)
    counts_s = t.counts.to(torch.float32) * s
    cur = torch.from_numpy(pwm).to(dev, torch.float32)
    change, it = F32(W), 0
    while change > F32(min_change) and it < max_iter:
        odds = _outer(cur) / bg_max
        r = counts_s / (s / odds + 1.0)
        if control:
            r = tf32(r)
        new = _marginals(r, W)
        rs = ((new[:, 0] + new[:, 1]) + new[:, 2]) + new[:, 3]
        new = new / rs[:, None]
        d = (new - cur).abs().reshape(-1).cpu().numpy()
        change = F32(0)
        for x in d:
            change = F32(change + x)
        cur, it = new, it + 1
    return cur.cpu().numpy().astype(F32), it


# -- motifs on the host ------------------------------------------------------


def normalize(pwm: np.ndarray) -> np.ndarray:
    out = pwm.astype(F32).copy()
    for p in range(out.shape[0]):
        r = out[p]
        out[p] = r / F32(F32(F32(r[0] + r[1]) + r[2]) + r[3])
    return out


@dataclass(eq=False)
class Motif:
    pwm: np.ndarray
    n_sites: int
    log_pvalue: np.float32
    bg_p: np.float32
    local: np.ndarray = None

    def __post_init__(self):
        if self.local is None:
            self.local = np.full(self.pwm.shape[0], self.n_sites, np.int64)

    @property
    def length(self) -> int:
        return self.pwm.shape[0]

    @property
    def comp(self) -> np.ndarray:
        return self.pwm[::-1, ::-1].copy()


def _d(p1, p2, off1, off2, n, eps=1e-4) -> np.float32:
    """sum over ``n`` rows and the bases of (x1+e) log2(x1+e) +
    (x2+e) log2(x2+e) - 2 m log2(m), m = (x1 + x2 + 2e) / 2: float
    operands, double logarithms, a float running sum."""
    e = F32(eps)
    d = F32(0)
    for i in range(n):
        for a in range(4):
            x1, x2 = F32(p1[off1 + i, a]), F32(p2[off2 + i, a])
            mean = F32(F32(F32(x1 + x2) + F32(2 * e)) / F32(2))
            d = F32(float(d) + float(x1 + e) * math.log2(x1 + e)
                    + float(x2 + e) * math.log2(x2 + e)
                    - 2 * float(mean) * math.log2(mean))
    return d


def d_bg(p, bg, n, off=0, eps=1e-4) -> np.float32:
    """Divergence of ``n`` rows of a PWM from the background."""
    return _d(p, np.tile(bg, (off + n, 1)), off, off, n, eps)


def similarity(p1, p2, bg, off1, off2, n) -> np.float32:
    """S = (d_bg(p1) + d_bg(p2)) / 2 - d(p1, p2) over ``n`` rows."""
    return F32(F32(0.5) * F32(d_bg(p1, bg, n, off1) + d_bg(p2, bg, n, off2))
               - _d(p1, p2, off1, off2, n))


def overlaps(m1: Motif, m2: Motif, bg):
    """S of every overlap of at least MIN_MERGE_OVERLAP rows, both
    orientations, as (S, shift, complement?) in upstream's loop order
    (iupac_pattern.cpp:568-615); upstream keeps the first largest."""
    lo, sh = (m2, m1) if m1.length < m2.length else (m1, m2)
    out = []
    for comp in (False, True):
        for shift in range(MIN_MERGE_OVERLAP - sh.length,
                           lo.length - MIN_MERGE_OVERLAP + 1):
            off_s, off_l = -min(shift, 0), max(shift, 0)
            n = min(lo.length - off_l, sh.length - off_s)
            pl, ps = lo.pwm, sh.pwm
            if comp and lo.n_sites < sh.n_sites:
                pl = lo.comp
            elif comp:
                ps = sh.comp
            out.append((similarity(pl, ps, bg, off_l, off_s, n), shift, comp))
    return out


def merge_pair(longer: Motif, shorter: Motif, comp: bool, bg,
               shift: int) -> Motif:
    """iupac_pattern.cpp:75-172 and :240-289."""
    off_s, off_l = -min(shift, 0), max(shift, 0)
    overlap = min(longer.length - off_l, shorter.length - off_s)
    pl, ps = longer.pwm, shorter.pwm
    if comp and longer.n_sites < shorter.n_sites:
        pl = longer.comp
    elif comp:
        ps = shorter.comp
    n_len = longer.length + shorter.length - overlap
    local = np.zeros(n_len, dtype=np.int64)
    local[max(shift, 0):max(shift, 0) + shorter.length] += shorter.local
    local[-min(shift, 0):-min(shift, 0) + longer.length] += longer.local
    pwm = np.zeros((n_len, 4), dtype=F32)
    for p in range(n_len):
        i_s, i_l = p - max(0, shift), p + min(shift, 0)
        in_s, in_l = 0 <= i_s < shorter.length, 0 <= i_l < longer.length
        if in_l and not in_s:
            pwm[p] = pl[i_l]
        elif in_s and not in_l:
            pwm[p] = ps[i_s]
        elif in_s and in_l:
            ws, wl = F32(shorter.local[i_s]), F32(longer.local[i_l])
            num = (ws * ps[i_s] + wl * pl[i_l]).astype(F32)
            pwm[p] = (num / F32(shorter.local[i_s] + longer.local[i_l])
                      ).astype(F32)
    # the p-value weighs the weaker motif's non-overlapping rows; the
    # shorter one's complement is taken unless the longer one's is
    # (upstream's own asymmetry)
    pl, ps = longer.pwm, shorter.pwm
    if comp and longer.n_sites < shorter.n_sites:
        pl = longer.comp
    else:
        ps = shorter.comp
    if longer.log_pvalue < shorter.log_pvalue:
        q, ql, qoff = ps, shorter.length, off_s
        base, other = longer.log_pvalue, shorter.log_pvalue
    else:
        q, ql, qoff = pl, longer.length, off_l
        base, other = shorter.log_pvalue, longer.log_pvalue
    if qoff != 0:
        d = d_bg(q, bg, qoff, 0)
    else:
        start = qoff + overlap
        d = d_bg(q, bg, ql - start, start)
    logp = F32(base + F32(d / d_bg(q, bg, ql)) * other)
    return Motif(normalize(pwm), int(local.sum()) // n_len, logp, F32(0),
                 local)


TIE = 1e-5   # scores this close (relative) are a tie


def merge_all(motifs: List[Motif], W: int, threshold: float,
              max_len: int, max_seq_len: int, bg, follow=()) -> List[Motif]:
    """peng.cpp:237-310: merge the most similar pair while its S exceeds
    W * threshold; motifs with log p above -5 take no part.

    Upstream takes the first of the pairs, and of a pair's overlaps, whose
    S tie exactly.  Reverse-complement twins among the candidates, and
    sites that are their own reverse complement, make such ties in every
    round, and in float32 which one comes out ahead is rounding.  Where
    overlaps tie within ``TIE`` here, the one the program took in its
    round (``follow``: its "merge: A + B -> C" lines as (A, B, C)) is
    taken, if it is among them: the one place the reference follows a
    decision of the program, and only between choices it finds equal."""
    motifs = list(motifs)
    cache: Dict = {}
    name = lambda m: pattern_string(m.pwm, bg)  # noqa: E731
    for rnd in itertools.count():
        options = []          # (S, i, j, shift, comp), upstream's order
        for i in range(len(motifs)):
            if motifs[i].log_pvalue > -5:
                continue
            for j in range(i + 1, len(motifs)):
                if motifs[j].log_pvalue > -5:
                    continue
                key = (motifs[i], motifs[j])    # held: ids are not reused
                if key not in cache:
                    cache[key] = overlaps(motifs[i], motifs[j], bg)
                options += [(o[0], i, j) + o[1:] for o in cache[key]]
        if not options:
            return motifs

        def merged(o):
            a, b = motifs[o[1]], motifs[o[2]]
            longer, shorter = (b, a) if a.length < b.length else (a, b)
            return merge_pair(longer, shorter, o[4], bg, o[3])

        best = max(options, key=lambda o: o[0])     # the first largest
        new = None
        if rnd < len(follow):
            for o in options:
                if o[0] < best[0] - TIE * abs(best[0]):
                    continue
                m = merged(o)
                if (name(motifs[o[2]]), name(motifs[o[1]]),
                        name(m)) == tuple(follow[rnd]):
                    best, new = o, m
                    break
        s, bi, bj = best[:3]
        if not (s > W * threshold and motifs[bi].length <= max_len
                and motifs[bj].length <= max_len):
            return motifs
        new = new or merged(best)
        if new.length > max_seq_len or new.length > max_len:
            return motifs
        del motifs[bj]
        del motifs[bi]
        motifs.append(new)


def by_log_pvalue(motifs: List[Motif]) -> List[Motif]:
    return sorted(motifs, key=lambda m: float(m.log_pvalue))


def filter_redundant(motifs: List[Motif], threshold: float,
                     bg) -> List[Motif]:
    """peng.cpp:199-235: of two motifs of one length whose S (either
    orientation) exceeds threshold * length, the later one goes; one
    removal per motif."""
    motifs = by_log_pvalue(motifs)
    gone = set()
    for i in range(len(motifs)):
        if i in gone:
            continue
        for j in range(i + 1, len(motifs)):
            if j in gone or motifs[i].length != motifs[j].length:
                continue
            n = motifs[i].length
            thr = F32(threshold) * n
            if (similarity(motifs[i].pwm, motifs[j].pwm, bg, 0, 0, n) > thr
                    or similarity(motifs[i].comp, motifs[j].pwm, bg, 0, 0,
                                  n) > thr):
                gone.add(j)
                break
    return [m for k, m in enumerate(motifs) if k not in gone]


def no_zero(pwm: np.ndarray, precision: int = 8) -> np.ndarray:
    """utils.h:40-49: an epsilon that keeps every printed cell above 0."""
    delta = F32(10.0 ** -precision)
    return normalize(pwm + F32(delta / F32(F32(1) - F32(4) * delta)))


def pattern_string(pwm: np.ndarray, bg0) -> str:
    """The nearest IUPAC letter of each row (iupac_pattern.cpp:215-238,
    699-718): each letter's profile is 0.2 * bg, plus 0.7 on the bases
    it stands for; the distance is the Jensen-Shannon-like divergence."""
    eps = 1e-7
    prof = np.array([[F32(MIXIN_FACTOR * F32(bg0[a]))
                      + (MIXIN_BIAS if b in IUPAC[c] else F32(0))
                      for a, b in enumerate("ACGT")] for c in IUPAC_ORDER],
                    dtype=F32).astype(np.float64)
    rows = pwm.astype(np.float64)[:, None, :]
    p1, p2 = rows + eps, prof[None] + eps
    mean = ((rows + prof[None] + 2 * eps) / 2).astype(F32).astype(np.float64)
    d = (p1 * np.log2(p1) + p2 * np.log2(p2) - 2 * mean * np.log2(mean)
         ).sum(axis=-1)
    return "".join(IUPAC_ORDER[i] for i in np.argmin(d, axis=1))
