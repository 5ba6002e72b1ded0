"""The plain reference that decides a run's ``correct``: NumPy for the
count layer (:mod:`.count`), PyTorch for the motif stages
(:mod:`.motifs`).  It imports nothing of the program under test and
takes nothing the program made: it reads the corpus the benchmark wrote
and the deployment's settings, selects the seeds, climbs and filters
(:mod:`.climb`), and makes the motifs of what it found (:mod:`.motifs`).
Of a job's printed output it reads only the choices the job made between
options it finds equal (:func:`climb.search`, :func:`motifs.merge_all`)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from . import count as C
from . import motifs as M


@dataclass
class Settings:
    """The deployment's flags that the reference reads (upstream
    defaults, src/Global.cpp:12-56)."""

    W: int = 10
    zscore_threshold: float = 10.0
    count_threshold: int = 3
    max_optimized: int = 50
    bg_order: int = 2            # order of the background model and z-scores
    pseudo_counts: int = 10
    em_saturation: float = 1e4
    em_min_change: float = 0.08
    em_max_iterations: int = 10
    merge_bit_factor: float = 0.4
    max_merged_length: int = 14


@dataclass
class Corpus:
    """The corpus's count layer, worked out from its FASTA file."""

    table: np.ndarray            # [4**W] int64, mirrored
    ltot: int
    bg: List[np.ndarray]         # (k+1)-mer counts, k = 0..bg_order
    max_seq_len: int
    n_seq: int

    @classmethod
    def of(cls, fasta: str, s: Settings) -> "Corpus":
        codes, offsets = C.read_fasta(fasta)
        table, ltot = C.count_table(codes, offsets, s.W)
        return cls(table, ltot, C.bg_counts(codes, offsets, s.bg_order),
                   int(np.diff(offsets).max()), offsets.shape[0] - 1)


def tables(corpus: Corpus, s: Settings, device) -> M.Tables:
    return M.Tables(s.W, torch.from_numpy(corpus.table).to(device),
                    corpus.ltot, M.conditionals(corpus.bg),
                    min(s.W - 1, s.bg_order))


def expected_motifs(t: M.Tables, corpus: Corpus, candidates: List[str],
                    s: Settings, control: bool = False, merges=(),
                    agg: M.Aggregates = None) -> List[dict]:
    """The MEME motifs, in the file's order, that the stages after the
    climb make of ``candidates``: each as name, width, nsites, log p,
    background probability and rows (as written, epsilon included).
    ``merges``: the program's merge lines, for ties only
    (:func:`motifs.merge_all`); ``agg``: the patterns' aggregates, if
    already at hand."""
    bg0 = t.v[0]
    # the EM's background: the same order here (order_k == max order)
    bg_max = t.bgp
    agg = agg or M.Aggregates(t)
    found = []
    for pat, (n, mu, bgp) in zip(candidates, agg(candidates)):
        logp = M.iupac_log_pvalue(n, mu, M.zscore(n, mu), pat)
        pwm0 = M.adv_pwm(t, pat, s.pseudo_counts, control)
        pwm, _ = M.em(pwm0, t, bg_max, s.em_saturation, s.em_min_change,
                      s.em_max_iterations, control)
        found.append(M.Motif(M.normalize(pwm), n, logp, bgp))
    merged = M.merge_all(found, s.W, s.merge_bit_factor,
                         s.max_merged_length, corpus.max_seq_len, bg0,
                         follow=merges)
    kept = M.by_log_pvalue(M.filter_redundant(merged, s.merge_bit_factor,
                                              bg0))
    return [dict(name=M.pattern_string(m.pwm, bg0), w=m.length,
                 nsites=m.n_sites, logp=float(m.log_pvalue),
                 bg_prob=float(m.bg_p), rows=M.no_zero(m.pwm))
            for m in kept]
