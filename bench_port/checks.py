"""The numbers that decide ``correct``: every job's output held against
the plain reference (:mod:`bench_port.reference`), worked out once per
run from the corpus the benchmark wrote.

- ``count_diff``: entries of the count table, of ltot and of the
  background counts that differ from the reference's, summed over the
  jobs (each job's, as its count phase returned them; in a resumed cell
  the checkpoint's, which every job loads).
- ``bg_mismatch`` (resumed cells): background conditionals of the
  checkpoint that differ from the reference's by more than the file's
  seven digits and four float32 units.
- ``seed_mismatch``: places in the job's list of seeds that hold another
  pattern than the reference's selection (:func:`reference.climb.search`,
  at the job's own ``-t``).
- ``climb_mismatch``: climbs whose accepted rows or outcome differ from
  the reference's own climb of the same seed, and places in the list of
  candidates the filter left that hold another pattern.
- ``stats_mismatch``: printed counts of seeds, climb rows and candidates
  that are not the reference's, and printed z-scores further from the
  reference's than their two decimals' rounding.
- ``motif_mismatch``, ``pwm_err``, ``logp_err``: the MEME file against
  the motifs the reference makes of its own candidates
  (:func:`bench_port.compare.compare_motifs`).

Numbers are summed over the jobs, or their largest taken; each has a
limit in ``bench_port/limits/<cell>.json``, and :func:`judge` holds them
to it.
"""

from __future__ import annotations

import itertools
import os
from typing import Dict, List

import numpy as np

from . import compare as CP
from . import reference as R
from .reference import climb as RC
from .reference import motifs as M

EXACT = ("count_diff", "bg_mismatch", "seed_mismatch", "climb_mismatch",
         "stats_mismatch", "motif_mismatch")


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number within its limit."""
    return all(v <= limits[k] for k, v in numbers.items())


def settings(config: dict, argv: List[str]) -> R.Settings:
    s = config["settings"]
    if s["strand"] != "BOTH" or not s["em"] or not s["merging"]:
        raise ValueError("the reference covers both strands, EM and merging")
    if (not s["filter_neighbors"]
            or s["optimization_score"] != "MUTUAL_INFO"):
        raise ValueError("the reference climbs by mutual information, "
                         "neighbours filtered")
    return R.Settings(
        W=int(argv[argv.index("-w") + 1]), bg_order=s["bg_order"],
        pseudo_counts=s["pseudo_counts"], em_saturation=s["em_saturation"],
        em_min_change=s["em_min_change"],
        em_max_iterations=s["em_max_iterations"],
        merge_bit_factor=s["merge_bit_factor"],
        max_merged_length=s["max_merged_length"],
        zscore_threshold=s["zscore_threshold"],
        count_threshold=s["count_threshold"],
        max_optimized=s["max_optimized_patterns"])


def _flag(argv: List[str], flag: str, default):
    """The last value of ``flag`` in ``argv``, as the CLI reads it."""
    vals = [argv[i + 1] for i, a in enumerate(argv[:-1]) if a == flag]
    return type(default)(vals[-1]) if vals else default


def _count_diff(table, ltot, bg, corpus: R.Corpus) -> int:
    diff = int(np.count_nonzero(np.asarray(table) != corpus.table))
    diff += int(ltot != corpus.ltot)
    if bg is not None:
        diff += sum(int(np.count_nonzero(np.asarray(b) != c))
                    for b, c in zip(bg, corpus.bg))
        diff += abs(len(bg) - len(corpus.bg))
    return diff


def _checkpoint(path: str, W: int):
    """(table, ltot, conditionals) of a checkpoint directory, read as
    files (the upstream package's format: an npz and a BaMM file)."""
    data = np.load(os.path.join(path, f"counts_w{W}_both_strands.npz"))
    with open(os.path.join(path, "bg.hbcp")) as f:
        rows = [line for line in f if not line.startswith("#")]
    v = [np.array(r.split(), dtype=np.float64) for r in rows if r.strip()]
    return data["counts"], int(data["ltot"]), v


def bg_mismatch(got: List[np.ndarray], want: List[np.ndarray]) -> int:
    """Conditionals, as a file prints them (``%.6e``), further from the
    reference's than half a unit of their seventh digit and four float32
    units."""
    bad = abs(len(got) - len(want))
    for g, w in zip(got, want):
        if g.shape != w.shape:
            bad += 1
            continue
        w = w.astype(np.float64)
        half = 0.5 * 10.0 ** (np.floor(np.log10(np.abs(g))) - 6)
        slack = half + 2 ** -21 * np.abs(w)
        bad += int(np.count_nonzero(np.abs(g - w) > slack))
    return bad


def _z_off(printed: float, ref) -> bool:
    """A z-score printed with two decimals that is not the reference's."""
    ref = float(ref)
    return abs(printed - ref) > 0.005 + 1e-6 * max(1.0, abs(ref))


def _places(got: List[str], want: List[str]) -> int:
    return sum(a != b for a, b in itertools.zip_longest(got, want))


class _Reference:
    """What the reference makes of the corpus at one ``-t``: its search
    and motifs, and the job's printed statistics held against them; kept
    by what the job printed, since the jobs of a cell print alike."""

    def __init__(self, t, corpus, s, control):
        self.t, self.corpus, self.s, self.control = t, corpus, s, control
        self.agg = M.Aggregates(t)
        self.expected = t.expected.cpu().numpy()
        self.counts = t.counts.cpu().numpy()
        self.z = RC.zscores(self.counts, self.expected)
        self.memo = {}

    def __call__(self, st: dict, z_thr: float, count_thr: int) -> dict:
        key = (z_thr, count_thr, repr(st))
        if key not in self.memo:
            self.memo[key] = self._work(st, z_thr, count_thr)
        return self.memo[key]

    def _work(self, st, z_thr, count_thr):
        s = self.s
        found = RC.search(self.t, self.agg, self.corpus.n_seq, z_thr,
                          count_thr, s.max_optimized, job=st)
        out = dict(seed_mismatch=_places([r[0] for r in st["seeds"]],
                                         found.seeds))
        bad = abs(len(st["climbs"]) - len(found.climbs))
        for got, want in zip(st["climbs"], found.climbs):
            bad += int(got["seed"] != want.seed
                       or [r[0] for r in got["rows"]] != want.rows
                       or got["emitted"] != want.emitted)
        out["climb_mismatch"] = bad + _places(st["selected"], found.selected)

        stats = 0
        for pat, n, z in st["seeds"]:
            i = CP.pattern_ids(pat)
            stats += int(n != int(self.counts[i]) or _z_off(z, self.z[i]))
        rows = [r for b in st["climbs"] for r in b["rows"]]
        for (pat, n), (ref_n, _, _) in zip(
                rows, self.agg([r[0] for r in rows])):
            stats += int(n != ref_n)
        cands = st["candidates"]
        for (pat, n, z), (ref_n, mu, _) in zip(
                cands, self.agg([c[0] for c in cands])):
            stats += int(n != ref_n or _z_off(z, M.zscore(ref_n, mu)))
        out["stats_mismatch"] = stats

        out["want"] = R.expected_motifs(self.t, self.corpus, found.selected,
                                        s, merges=st["merges"], agg=self.agg)
        if self.control:
            low = R.expected_motifs(self.t, self.corpus, found.selected, s,
                                    control=True, merges=st["merges"],
                                    agg=self.agg)
            out["control"] = CP.compare_motifs(low, out["want"])
        return out


def check(cell: dict, fasta: str, jobs: List[dict], checkpoint, device,
          control: bool = False) -> Dict[str, float]:
    """The numbers of the docstring over ``jobs``.  With ``control``,
    also ``control.<number>``: the plain reference computed in the
    precision below the stated one (:mod:`bench_port.reference.motifs`),
    put in the program's place on the reference's own candidates; its
    counts, seeds and climbs are the reference's, so its exact numbers
    read 0."""
    import torch

    argv = cell["traffic"]["argv"]
    s = settings(cell["config"], argv)
    corpus = R.Corpus.of(fasta, s)
    t = R.tables(corpus, s, device)
    ref = _Reference(t, corpus, s, control)
    out = dict(count_diff=0, seed_mismatch=0, climb_mismatch=0,
               stats_mismatch=0, motif_mismatch=0, pwm_err=0.0, logp_err=0.0)
    if checkpoint:
        table, ltot, v = _checkpoint(checkpoint, s.W)
        out["count_diff"] += _count_diff(table, ltot, None, corpus)
        out["bg_mismatch"] = bg_mismatch(v, t.v)
    low = {}
    for job in jobs:
        if job["rc"] != 0:
            continue
        if job.get("count") is not None:
            out["count_diff"] += _count_diff(*job["count"], corpus)
        st = CP.parse_stdout(job["stdout"])
        job_argv = job.get("argv", argv)
        found = ref(st, _flag(job_argv, "-t", float(s.zscore_threshold)),
                    _flag(job_argv, "--count-threshold", s.count_threshold))
        for k in ("seed_mismatch", "climb_mismatch", "stats_mismatch"):
            out[k] += found[k]
        with open(job["out"]) as f:
            got = CP.parse_meme(f.read())
        cmp = CP.compare_motifs(got, found["want"])
        out["motif_mismatch"] += cmp["motif_mismatch"]
        out["pwm_err"] = max(out["pwm_err"], cmp["pwm_err"])
        out["logp_err"] = max(out["logp_err"], cmp["logp_err"])
        for k, v in found.get("control", {}).items():
            low[k] = max(low.get(k, 0), v)
    if control:
        out.update({"control." + k: (low.get(k, 0) if k not in EXACT
                                     or k == "motif_mismatch" else 0)
                    for k in out})
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    return out
