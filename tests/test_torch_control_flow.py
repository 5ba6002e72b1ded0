"""The greedy control flow the port copied from the reference package,
exercised directly with scripted scores: twins of
tests/test_control_flow.py.  Every test runs the same scripted input
through the reference package's function and the port's and asserts that
the two outcomes are equal (emitted flags, rows, final digits, motif
lists, stdout); the values the reference's own tests expect stand beside
them.  The climb's decision rules (src/peng.cpp:437-541) are held on the
host replay of the device walks (``ops/climb.replay_walks`` and the
engines' ``_replay_climb``): the scripted walks below are what the
lockstep device program would record — every walk runs to its own end,
blind to the other walks — and the replay applies the sequential seen-set
bookkeeping.  The merge loop and the redundancy filter
(src/peng.cpp:199-313) are held on ``pipeline.Peng``.
"""

import io
from types import SimpleNamespace

import numpy as np
import pytest

import conftest  # noqa: F401

import peng_motif_tpu.engine_tpu as ref_engine
import peng_motif_tpu.io.fasta as ref_fasta
import peng_motif_tpu.models.background as ref_background
import peng_motif_tpu.models.motif as ref_motif
import peng_motif_tpu.ops.climb as ref_climb
import peng_motif_tpu.pattern_tables as ref_tables
import peng_motif_tpu.pipeline as ref_pipeline
import peng_motif_tpu_torch.engine as port_engine
import peng_motif_tpu_torch.io.fasta as port_fasta
import peng_motif_tpu_torch.models.background as port_background
import peng_motif_tpu_torch.models.motif as port_motif
import peng_motif_tpu_torch.ops.climb as port_climb
import peng_motif_tpu_torch.pattern_tables as port_tables
import peng_motif_tpu_torch.pipeline as port_pipeline
from peng_motif_tpu_torch.alphabets import IUPAC_SIMILAR
from peng_motif_tpu_torch.ops.climb import ACC_CAP, MAXSIM, WalkTrace

# the same modules of the two packages, side by side
REFERENCE = SimpleNamespace(
    engine=ref_engine, fasta=ref_fasta, background=ref_background,
    motif=ref_motif, climb=ref_climb, tables=ref_tables,
    pipeline=ref_pipeline)
PORT = SimpleNamespace(
    engine=port_engine, fasta=port_fasta, background=port_background,
    motif=port_motif, climb=port_climb, tables=port_tables,
    pipeline=port_pipeline)
PACKAGES = (REFERENCE, PORT)

W = 4


def iupac_id(digits):
    return sum(int(d) * 11 ** p for p, d in enumerate(digits))


# IUPAC digit codes: A=0 C=1 G=2 T=3 S=4 W=5 R=6 Y=7 M=8 K=9 N=10
AAAA = iupac_id([0, 0, 0, 0])
WAAA = iupac_id([5, 0, 0, 0])
KAAA = iupac_id([9, 0, 0, 0])
RAAA = iupac_id([6, 0, 0, 0])
MAAA = iupac_id([8, 0, 0, 0])


def scripted_trace(scores, seed_scores, seeds, steps=8) -> WalkTrace:
    """The trace of the lockstep walks under a scripted score per IUPAC
    id (unlisted ids score 2.0; counts 1, bgp 1e-3 and expected == score
    throughout, the ENRICHMENT setting of the reference's fixture).  Each
    walk accepts every strict improvement over its running best in
    candidate order (position-major, similar-letter order), moves to the
    last one accepted, and ends at a step without one."""
    S = len(seeds)
    f = lambda *shape: np.zeros(shape, dtype=np.float32)  # noqa: E731
    improved = np.zeros((steps, S), dtype=bool)
    chosen_idx = np.zeros((steps, S), dtype=np.int32)
    chosen_expected, chosen_score = f(steps, S), f(steps, S)
    acc_idx = np.zeros((steps, S, ACC_CAP), dtype=np.int32)
    acc_expected, acc_score = f(steps, S, ACC_CAP), f(steps, S, ACC_CAP)
    acc_n = np.zeros((steps, S), dtype=np.int32)
    init_score = f(S)
    n_steps = 0
    for s, seed in enumerate(seeds):
        digits = [(seed >> (2 * p)) & 3 for p in range(W)]
        best = init_score[s] = np.float32(seed_scores[seed])
        for t in range(steps):
            n_steps = max(n_steps, t + 1)
            last = None
            for p in range(W):
                for j, letter in enumerate(IUPAC_SIMILAR[digits[p]]):
                    cand = digits[:p] + [letter] + digits[p + 1:]
                    score = np.float32(scores.get(iupac_id(cand), 2.0))
                    if score < best:
                        best = score
                        k = acc_n[t, s]
                        acc_idx[t, s, k] = p * MAXSIM + j
                        acc_expected[t, s, k] = acc_score[t, s, k] = score
                        acc_n[t, s] += 1
                        last = (p * MAXSIM + j, cand)
            if last is None:
                break
            improved[t, s] = True
            chosen_idx[t, s], digits = last
            chosen_expected[t, s] = chosen_score[t, s] = best
    ones = lambda *shape: np.ones(shape, dtype=np.float32)  # noqa: E731
    return WalkTrace(
        improved=improved, chosen_idx=chosen_idx,
        chosen_counts=ones(steps, S), chosen_expected=chosen_expected,
        chosen_bgp=np.full((steps, S), 1e-3, np.float32),
        chosen_score=chosen_score, acc_idx=acc_idx,
        acc_counts=ones(steps, S, ACC_CAP), acc_expected=acc_expected,
        acc_score=acc_score, acc_n=acc_n, init_counts=ones(S),
        init_expected=np.full(S, 2.0, np.float32),
        init_bgp=np.full(S, 1e-3, np.float32), init_score=init_score,
        n_steps=n_steps, overflow=False)


def _tiny_peng(pkg, out):
    seqs = [np.array([1, 2, 3, 4, 1, 2, 3, 4], dtype=np.uint8)] * 2
    sset = pkg.fasta.SequenceSet(filepath="<mem>", sequences=seqs,
                                 headers=["a", "b"])
    bg = pkg.background.BackgroundModel(seqs, order=0)
    return pkg.pipeline.Peng(pkg.tables.Strand.BOTH_STRANDS, 0, 0, sset, bg,
                             stdout=out)


def _replay(pkg, trace, seeds, w=W):
    """One package's replay of a scripted trace: the walks' outcomes as
    plain values, the emitted motifs' pattern ids and the climb's stdout."""
    trace = pkg.climb.WalkTrace(*trace)
    outcomes = [
        (oc.emitted, iupac_id(oc.final_digits), int(oc.final_counts),
         float(oc.final_expected), float(oc.final_bgp),
         [(iupac_id(r[0]), int(r[1]), float(r[2]), float(r[3]))
          for r in oc.rows])
        for oc in pkg.climb.replay_walks(trace, seeds, w)]
    out = io.StringIO()
    motifs = pkg.engine._replay_climb(_tiny_peng(pkg, out), None, trace,
                                      seeds, w)
    return SimpleNamespace(outcomes=outcomes,
                           motifs=[m.pattern_id for m in motifs],
                           text=out.getvalue())


def _replay_both(trace, seeds, w=W):
    """The port's replay, after holding it equal to the reference's."""
    ref, port = (_replay(pkg, trace, seeds, w) for pkg in PACKAGES)
    assert port.outcomes == ref.outcomes
    assert port.motifs == ref.motifs
    assert port.text == ref.text
    return port


def test_seen_set_kills_duplicate_and_evaluated_walks():
    """Three seeds (reference walk src/peng.cpp:465-524):
    - AAAA climbs to WAAA (score 0.5) and emits it;
    - TAAA also reaches WAAA -> best in `seen` -> removed; along the
      way it *evaluates* KAAA (0.6, not accepted: 0.6 > running 0.5)
      which is recorded into `seen` (all evaluated mutants except the
      current best, src/peng.cpp:507-508);
    - GAAA's best move is KAAA -> killed purely by walk 2's evaluation
      record, the adversarial case of the seen-set rule."""
    scores = {AAAA: 2.0, WAAA: 0.5, KAAA: 0.6}
    # seeds as base-4 ids: AAAA=0, TAAA=3, GAAA=2
    seeds = [0, 3, 2]
    trace = scripted_trace(scores, {0: 1.0, 3: 1.0, 2: 1.0}, seeds)
    got = _replay_both(trace, seeds)
    # what tests/test_control_flow.py expects of the sequential walk:
    # emitted [True, False, False]; walk 2 dies on WAAA, walk 3 on KAAA,
    # each after its one accepted row; motifs [WAAA]; "removed" twice
    assert [oc[0] for oc in got.outcomes] == [True, False, False]
    assert [oc[1] for oc in got.outcomes] == [WAAA, WAAA, KAAA]
    assert [len(oc[5]) for oc in got.outcomes] == [2, 2, 2]
    assert got.motifs == [WAAA]
    assert got.text.count("removed") == 2
    assert "optimization: AAAA -> WAAA" in got.text


def test_walk_accepts_every_strict_improvement_in_order():
    """Within one mother, later candidates compare against the running
    best-so-far, not the step's start (src/peng.cpp:485-497): 0.8 then
    0.3 both print as accepted rows; a following 0.5 does not."""
    # From AAAA, pos-0 candidates arrive in similar-set order W, R, M, N
    scores = {WAAA: 0.8, RAAA: 0.3, MAAA: 0.5}
    trace = scripted_trace(scores, {0: 1.0}, [0])
    assert trace.acc_n[0, 0] == 2
    got = _replay_both(trace, [0])
    (oc,) = got.outcomes
    assert oc[0] and oc[1] == RAAA
    assert [r[0] for r in oc[5]] == [AAAA, WAAA, RAAA]
    assert [r[3] for r in oc[5]] == [1.0, np.float32(0.8), np.float32(0.3)]
    assert got.motifs == [RAAA]
    assert "WAAA" in got.text and "RAAA" in got.text
    # MAAA at 0.5 > running 0.3 must never print as an accepted row
    assert "\tMAAA" not in got.text


def test_unimproved_walk_emits_its_seed_once():
    """A walk without any improvement emits its seed pattern; a second
    seed whose walk ends on an already emitted pattern is removed."""
    seeds = [0, 0]
    trace = scripted_trace({}, {0: 1.0}, seeds)
    first, second = _replay_both(trace, seeds).outcomes
    assert first[0] and first[1] == AAAA
    assert not second[0]


def test_seed_killed_on_its_first_step():
    """A walk whose first chosen mutant is already in the seen set dies
    there, after printing its seed row and that step's accepted rows."""
    seeds = [0, 0]
    trace = scripted_trace({WAAA: 0.5}, {0: 1.0}, seeds)
    first, second = _replay_both(trace, seeds).outcomes
    assert first[0] and first[1] == WAAA
    # WAAA entered the seen set when the first walk emitted it
    assert not second[0] and second[1] == WAAA and len(second[5]) == 2


def _walk_back(trace, s):
    """Seed s's walk from AAAA to MAAA, then a second step onto WAAA, a
    candidate of its first step: the device's trace of a walk the seen
    set stops on its own earlier candidates."""
    trace = trace._replace(**{k: getattr(trace, k).copy() for k in (
        "improved", "chosen_idx", "chosen_expected", "chosen_score",
        "acc_idx", "acc_expected", "acc_score", "acc_n")})
    w_of_m = IUPAC_SIMILAR[8].index(5)          # W among M's letters
    trace.improved[1, s] = True
    trace.chosen_idx[1, s] = trace.acc_idx[1, s, 0] = w_of_m
    trace.acc_n[1, s] = 1
    for k in ("chosen_expected", "chosen_score"):
        getattr(trace, k)[1, s] = 0.25
    trace.acc_expected[1, s, 0] = trace.acc_score[1, s, 0] = 0.25
    return trace


def test_every_walk_removed():
    """Walks that end on a pattern of the seen set are all removed: no
    motif, the table's header alone."""
    seeds = [0, 0]
    trace = scripted_trace({MAAA: 0.5}, {0: 1.0}, seeds)
    trace = _walk_back(_walk_back(trace, 0), 1)
    got = _replay_both(trace, seeds)
    assert [oc[0] for oc in got.outcomes] == [False, False]
    assert [oc[1] for oc in got.outcomes] == [WAAA, WAAA]
    assert got.motifs == []
    assert got.text.count("removed") == 2


def test_zero_expected_prints_inf_enrichment(monkeypatch):
    """A climb row whose expected count is 0 prints its enrichment as
    "inf".  The reference computes a z-score for every row, which a zero
    expected count makes a ZeroDivisionError; no row prints it, so the
    reference's z here reads inf at a zero expected count."""
    zscore = ref_motif.numerics.zscore_from_sums
    monkeypatch.setattr(
        ref_motif.numerics, "zscore_from_sums",
        lambda n, e: np.float32(np.inf) if e == 0 else zscore(n, e))
    scores = {WAAA: 0.8, RAAA: 0.3}
    trace = scripted_trace(scores, {0: 1.0}, [0])
    trace.acc_expected[0, 0, 0] = 0.0      # the WAAA row, not the end
    trace.acc_expected[0, 0, 1] = -0.0     # the RAAA row: -0.0 is false
    got = _replay_both(trace, [0])
    assert got.text.count("\t  inf\t") == 2
    assert got.motifs == [RAAA]


def test_nan_prints_as_python_does():
    """A NaN enrichment or score prints "nan" whatever its sign bit."""
    scores = {WAAA: 0.8, RAAA: 0.3}
    trace = scripted_trace(scores, {0: 1.0}, [0])
    nan = -np.float32(np.nan)
    assert np.signbit(nan)
    trace.acc_expected[0, 0, 0] = nan       # the WAAA row's enrichment
    trace.acc_score[0, 0, 0] = nan
    # NaN rows differ from themselves, so the outcomes compare as text
    ref, got = (_replay(pkg, trace, [0]) for pkg in PACKAGES)
    assert got.text == ref.text and got.motifs == ref.motifs == [RAAA]
    assert "\t  nan\t       nan\n" in got.text and "-nan" not in got.text


def test_counts_past_float32_integers():
    """Counts of 2**24 and more (the f64 chain's int64 trace) print
    exactly; the enrichment divides their float32 rounding."""
    scores = {WAAA: 0.8, RAAA: 0.3}
    trace = scripted_trace(scores, {0: 1.0}, [0])
    acc_counts = np.zeros(trace.acc_counts.shape, np.int64)
    acc_counts[..., 0], acc_counts[..., 1] = 2 ** 24 + 1, 2 ** 31 - 1
    trace = trace._replace(
        init_counts=np.full(1, 2 ** 24 + 3, np.int64), acc_counts=acc_counts,
        chosen_counts=np.full(trace.chosen_counts.shape, 123_456_789,
                              np.int64))
    got = _replay_both(trace, [0])
    assert "\t  16777219\t" in got.text and "\t2147483647\t" in got.text
    assert got.outcomes[0][2] == 123_456_789


def random_trace(w, seed, steps=10) -> tuple:
    """(trace, seeds): walks of valid moves at width w, as the lockstep
    device program records them, with random aggregates and scores.  A
    repeated seed and its neighbours walk into each other's seen sets;
    moves favour the first positions so that walks meet."""
    rng = np.random.default_rng(seed)
    base = [int(x) for x in rng.integers(0, 4 ** w, size=5)]
    seeds = base + [base[0], base[1] ^ 1, base[2] ^ 2, base[0] ^ 3, base[3]]
    S = len(seeds)
    tr = scripted_trace({}, {x: 1.0 for x in seeds}, seeds, steps=steps)
    tr = tr._replace(
        acc_counts=rng.integers(0, 2 ** 31, size=tr.acc_idx.shape),
        chosen_counts=np.zeros((steps, S), np.int64),
        init_counts=rng.integers(0, 2 ** 31, size=S),
        init_expected=rng.uniform(0.5, 5e4, S).astype(np.float32),
        init_bgp=rng.uniform(1e-9, 1e-3, S).astype(np.float32))
    for s, seed_id in enumerate(seeds):
        digits = [(seed_id >> (2 * p)) & 3 for p in range(w)]
        score = np.float32(rng.normal())
        tr.init_score[s] = score
        for t in range(int(rng.integers(0, steps))):
            picks = sorted({(int(rng.integers(0, min(w, 3))),
                             int(rng.integers(0, 4)))
                            for _ in range(int(rng.integers(1, 4)))})
            for k, (p, j) in enumerate(picks):
                score = np.float32(score - rng.uniform(0.01, 1.0))
                tr.acc_idx[t, s, k] = p * MAXSIM + j
                tr.acc_expected[t, s, k] = rng.uniform(0.5, 5e4)
                tr.acc_score[t, s, k] = score
            tr.acc_n[t, s] = len(picks)
            k = len(picks) - 1
            tr.improved[t, s] = True
            tr.chosen_idx[t, s] = tr.acc_idx[t, s, k]
            tr.chosen_counts[t, s] = tr.acc_counts[t, s, k]
            tr.chosen_expected[t, s] = tr.acc_expected[t, s, k]
            tr.chosen_score[t, s] = tr.acc_score[t, s, k]
            tr.chosen_bgp[t, s] = rng.uniform(1e-9, 1e-3)
            p, j = picks[-1]
            digits[p] = IUPAC_SIMILAR[digits[p]][j]
    return tr, seeds


@pytest.mark.parametrize("w", range(4, 13))
def test_random_walks_match_reference(w):
    """Random walks at every width of the device engine: outcomes, motifs
    and the climb's text byte for byte."""
    trace, seeds = random_trace(w, seed=w)
    got = _replay_both(trace, seeds, w)
    emitted = [oc[0] for oc in got.outcomes]
    assert any(emitted) and not all(emitted)


def test_widest_key_replays_and_wider_raises():
    """Keys are base-11 in 64 bits: W = 18 (11**18 < 2**63) replays as the
    reference does; at W = 19 the port raises rather than wrap."""
    seeds = [0, 3]
    trace = scripted_trace({}, {0: 1.0, 3: 1.0}, seeds)
    got = _replay_both(trace, seeds, 18)
    assert got.motifs == [0, 3]
    with pytest.raises(OverflowError, match="11\\*\\*19"):
        port_climb.replay_walks(trace, seeds, 19)


class FakeMotif:
    def __init__(self, name, length, log_pvalue=-10.0):
        self.name = name
        self.length = length
        self.log_pvalue = log_pvalue

    def pattern_string(self, profile):
        return self.name


def _merge(pkg, monkeypatch, motifs, overlap, merged=None):
    """One package's ``Peng._merge_patterns`` over fake motifs with a
    scripted overlap score: the names left, the pairs scored, stdout."""
    out = io.StringIO()
    peng = _tiny_peng(pkg, out)
    calls = []

    def fake_overlap(m1, m2, both, bg0):
        calls.append((m1.name, m2.name))
        return np.float32(overlap(m1.name, m2.name)), 0, False

    monkeypatch.setattr(pkg.pipeline, "calculate_best_overlap", fake_overlap)
    if merged is not None:
        monkeypatch.setattr(pkg.pipeline, "merge_motifs",
                            lambda *args, **kw: FakeMotif(*merged))
    motifs = [FakeMotif(*m) for m in motifs]
    peng._merge_patterns(8, 0.4, motifs, 14)
    return [m.name for m in motifs], calls, out.getvalue()


def _merge_both(monkeypatch, *args, **kw):
    ref, port = (_merge(pkg, monkeypatch, *args, **kw) for pkg in PACKAGES)
    assert port == ref
    return port


def test_merge_too_long_terminates_loop_not_pair(monkeypatch):
    """When the best pair's merge exceeds max_merged_length, the
    reference ends the whole merge phase rather than trying the next
    pair (src/peng.cpp:308-310 `continue` with found_better false)."""
    # (A,B) is the best pair; (A,C) also clears the threshold; the merge
    # is 20 long, > max_merged_length = 14
    names, _calls, text = _merge_both(
        monkeypatch, [("A", 8), ("B", 8), ("C", 8)],
        lambda a, b: 9.0 if {a, b} == {"A", "B"} else 8.0, ("AB", 20))
    # no merge happened and the (A,C) pair was never merged either
    assert names == ["A", "B", "C"]
    assert "merge:" not in text


def test_merge_takes_the_best_pair_and_goes_on(monkeypatch):
    """A merge that fits replaces its pair (appended last) and the loop
    scores the new list again."""
    names, calls, text = _merge_both(
        monkeypatch, [("A", 4), ("B", 4), ("C", 4)],
        lambda a, b: 9.0 if {a, b} == {"A", "B"} else 0.0, ("AB", 6))
    assert names == ["C", "AB"]
    assert text.count("merge: B + A -> AB") == 1
    # round 1 scores the three pairs, round 2 only the new one
    assert calls == [("A", "B"), ("A", "C"), ("B", "C"), ("C", "AB")]


def test_merge_skips_weak_pvalue_motifs(monkeypatch):
    """Motifs with log_pvalue > -5 never participate in merging
    (src/peng.cpp:249-252)."""
    names, calls, _text = _merge_both(
        monkeypatch, [("A", 8, -1.0), ("B", 8, -1.0)], lambda a, b: 99.0)
    assert calls == []
    assert names == ["A", "B"]


def _filter(pkg, monkeypatch, motifs, s_value):
    """One package's ``Peng.filter_redundancy`` over flat-PWM motifs
    (name, log p-value, length) with a scripted similarity: the names
    left, the lengths scored, stdout."""
    out = io.StringIO()
    peng = _tiny_peng(pkg, out)
    made = []
    for name, logp, length in motifs:
        m = pkg.motif.Motif(0, length)
        m.log_pvalue = np.float32(logp)
        m.set_pwm(np.full((length, 4), 0.25, dtype=np.float32))
        m.name = name
        made.append(m)
    seen = []

    def fake_s(p1, p2, bg0, o1, o2, length):
        seen.append(length)
        return np.float32(s_value)

    monkeypatch.setattr(pkg.pipeline, "calculate_s", fake_s)
    peng.filter_redundancy(0.4, made)
    return [m.name for m in made], seen, out.getvalue()


def _filter_both(monkeypatch, *args):
    ref, port = (_filter(pkg, monkeypatch, *args) for pkg in PACKAGES)
    assert port == ref
    return port


def test_redundancy_filter_breaks_after_one_deselection(monkeypatch):
    """With A,B,C mutually similar, the reference deselects B under
    i=A then breaks the j loop — C survives (src/peng.cpp:199-235
    break-per-i quirk)."""
    # the filter re-sorts by log_pvalue first
    names, _seen, _text = _filter_both(
        monkeypatch, [("C", -10.0, W), ("A", -30.0, W), ("B", -20.0, W)], 1e9)
    assert names == ["A", "C"]


def test_redundancy_filter_keeps_dissimilar_and_other_lengths(monkeypatch):
    names, seen, _text = _filter_both(
        monkeypatch, [("B", -20.0, 6), ("C", -10.0, 4), ("A", -30.0, 4)], 0.0)
    # only the equal-length pair (A, C) is scored, with both strands
    assert names == ["A", "B", "C"]
    assert seen == [4, 4]
