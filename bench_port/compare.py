"""What a job printed and wrote, read back, and held against the plain
reference (:mod:`bench_port.reference`)."""

from __future__ import annotations

import re
from typing import Dict, List

import numpy as np

_COMP = str.maketrans("ACGTSWRYMKN", "TGCASWYRKMN")
_ROW = re.compile(r"^\s*([ACGTSWRYMKN]+)\s+(\d+)\s+(\S+)\s+(\S+)\s*$")


def revcomp(pattern: str) -> str:
    return pattern.translate(_COMP)[::-1]


def parse_stdout(text: str) -> Dict[str, list]:
    """A job's stdout: ``seeds`` and ``candidates`` (the two tables headed
    "pattern observed enrichment zscore": the seeds, and what the climb
    made of them) as (pattern, observed, zscore); ``climbs``, one per
    seed climbed: its ``seed``, the ``rows`` it accepted after the seed
    as (pattern, observed), and the pattern it ``emitted`` (None:
    removed); ``selected`` (the candidates left after the filter, in
    their order) and ``merges`` (each merge's two motifs and its result,
    as printed)."""
    tables: List[list] = []
    climbs, selected, merges = [], [], []
    block = None
    for line in text.splitlines():
        words = line.split()
        if words[:4] == ["pattern", "observed", "enrichment", "zscore"]:
            tables.append([])
        elif line.startswith("selected iupac pattern: "):
            selected.append(words[-1])
        elif line.startswith("merge: ") and len(words) == 6:
            merges.append((words[1], words[3], words[5]))
        elif line.startswith("optimization: ") and block is not None:
            block["emitted"] = words[3] if len(words) == 4 else None
            climbs.append(block)
            block = None
        elif line.startswith("[STATUS]") or line.startswith("\t"):
            if tables and tables[-1] is not None:
                tables.append(None)          # a table ends here
            if line.startswith("\t") and len(words) == 4:
                if block is None:
                    block = dict(seed=words[0], rows=[], emitted=None)
                else:
                    block["rows"].append((words[0], int(words[1])))
        elif tables and tables[-1] is not None:
            m = _ROW.match(line)
            if m:
                tables[-1].append((m.group(1), int(m.group(2)),
                                   float(m.group(4))))
    tables = [t for t in tables if t is not None]
    return dict(seeds=tables[0] if tables else [],
                candidates=tables[1] if len(tables) > 1 else [],
                climbs=climbs, selected=selected, merges=merges)


def parse_meme(text: str) -> List[dict]:
    """The motifs of a MEME file, in its order."""
    motifs = []
    lines = text.splitlines()
    for i, line in enumerate(lines):
        if not line.startswith("MOTIF "):
            continue
        head = dict(re.findall(r"(\S+)= (\S+)", lines[i + 1]))
        w = int(head["w"])
        rows = np.array([[float(x) for x in lines[i + 2 + r].split()]
                         for r in range(w)])
        motifs.append(dict(name=line.split()[1], w=w,
                           nsites=int(head["nsites"]),
                           logp=float(head["log(Pval)"]),
                           logp_half=half_unit(head["log(Pval)"]),
                           rows=rows))
    return motifs


def half_unit(text: str) -> float:
    """Half a unit of the last digit a number is printed with."""
    mant, _, exp = text.lower().partition("e")
    digits = len(mant.partition(".")[2])
    return 0.5 * 10.0 ** (int(exp or 0) - digits)


def pattern_ids(pattern: str) -> int:
    """The little-endian id of a plain ACGT pattern."""
    return sum("ACGT".index(c) << (2 * p) for p, c in enumerate(pattern))


def compare_motifs(got: List[dict], want: List[dict]) -> dict:
    """``motif_mismatch``: motifs that have no counterpart of the same
    width, name (or its reverse complement) and nsites, plus the
    difference in their number; ``pwm_err``: the widest gap of a PWM
    cell, orientation matched; ``logp_err``: the widest gap of log p,
    beyond half a unit of the last digit the file prints, relative to
    the reference's."""
    mismatch = abs(len(got) - len(want))
    pwm_err = logp_err = 0.0
    free = list(range(len(want)))
    for g in got:
        best = None
        for k in free:
            w = want[k]
            if w["w"] != g["w"]:
                continue
            for rows in (w["rows"], w["rows"][::-1, ::-1]):
                err = float(np.abs(g["rows"] - rows).max())
                if best is None or err < best[0]:
                    best = (err, k)
        if best is None:
            mismatch += 1
            continue
        err, k = best
        w = want[k]
        free.remove(k)
        if (g["name"] not in (w["name"], revcomp(w["name"]))
                or g["nsites"] != w["nsites"]):
            mismatch += 1
        pwm_err = max(pwm_err, err)
        gap = abs(g["logp"] - w["logp"]) - g.get("logp_half", 0.0)
        logp_err = max(logp_err, max(gap, 0.0) / max(abs(w["logp"]), 1.0))
    return dict(motif_mismatch=mismatch, pwm_err=pwm_err, logp_err=logp_err)
