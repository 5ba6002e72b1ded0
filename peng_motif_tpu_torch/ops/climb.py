"""The IUPAC hill climb: lockstep device walks + host seen-set replay.

Counterpart of ``peng_motif_tpu/ops/climb.py``.  Reference control flow
(src/peng.cpp:437-541): for each selected seed, repeatedly evaluate
every single-position IUPAC mutation ("similar" letters,
src/iupac_alphabet.cpp:47-136) of the current best pattern, in
position-major order, accepting every strict improvement of the
optimization score; a global ``seen`` set kills a walk when its step's
best pattern was evaluated before, and decides final emission.

A walk's trajectory is independent of the seen set: the seen set only
decides where a walk *stops* (src/peng.cpp:504-506) and whether its
endpoint is *emitted* (src/peng.cpp:511-524).  So the device runs all S
walks in lockstep, one step per loop iteration evaluating all
S x W x 10 single-position mutants through marginal tables, and the
host replays the sequential seen-set bookkeeping over the returned
trajectories in seed order, in one native pass that also writes the
climb's text (``csrc/replay.cpp``: :func:`replay`).  On a CUDA device
the mutants' aggregates come from one hand-written kernel that gathers
the table rows each mask set matches (``csrc/climb.cu``:
:func:`climb_aggregates`), and the step is captured once into a CUDA
graph and replayed; elsewhere a dense contraction over the whole table
computes them (the kernel's yardstick).

Scores are computed with the reference's float32-storage /
float64-transcendental promotion points (ops/flat_tables) and compared
as float32.  Count sums are exact in the f32 chain while ltot < 2**24;
``wide`` runs the aggregation chain in f64 (exact to 2**53).
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from . import flat_tables as ft
from .histogram import build_kernels, on_device
from ..alphabets import (IUPAC_CHARS, IUPAC_MASKS, IUPAC_SIMILAR,
                         LOG_BONFERRONI)
from ..native import climb_replay_native
from ..utils.logging_utils import count, span, sync_read, upload

F32 = torch.float32

MAXSIM = max(len(s) for s in IUPAC_SIMILAR)  # 10 (letter N)

# [11, MAXSIM] similar-letter table, -1 padded, reference order
SIM_TABLE = np.full((len(IUPAC_SIMILAR), MAXSIM), -1, dtype=np.int32)
for _c, _sims in enumerate(IUPAC_SIMILAR):
    SIM_TABLE[_c, : len(_sims)] = _sims

# [11, 1 + MAXSIM] the kernel's letter table: each letter's 4-bit base mask
# (bit d: base d), then its similar letters
LETTER_TABLE = np.concatenate(
    [(np.asarray(IUPAC_MASKS, dtype=np.int32)
      << np.arange(4, dtype=np.int32)).sum(1, dtype=np.int32)[:, None],
     SIM_TABLE], axis=1)

MAX_STEPS = 48     # longest supported walk (score strictly decreases
                   # each step; real walks take ~15 steps at W=10)
ACC_CAP = 12       # per-step accepted-row trace slots (running-min
                   # improvements within one step's ~W*10 candidates)


class ClimbOverflow(RuntimeError):
    """A walk outran MAX_STEPS steps or accepted more than ACC_CAP rows
    in one step."""


class WalkTrace(NamedTuple):
    """Host-side (numpy) view of the lockstep walk run.  T = MAX_STEPS
    trace rows (the first n_steps are written), S = number of seeds."""

    improved: np.ndarray         # [T, S] bool — step strictly improved
    chosen_idx: np.ndarray       # [T, S] int32 candidate index (p*MAXSIM+j)
    chosen_counts: np.ndarray    # [T, S] f32 (exact integers; int64 wide)
    chosen_expected: np.ndarray  # [T, S] f32
    chosen_bgp: np.ndarray       # [T, S] f32
    chosen_score: np.ndarray     # [T, S] f32
    acc_idx: np.ndarray          # [T, S, R] int32
    acc_counts: np.ndarray       # [T, S, R] f32 (int64 wide)
    acc_expected: np.ndarray     # [T, S, R] f32
    acc_score: np.ndarray        # [T, S, R] f32
    acc_n: np.ndarray            # [T, S] int32
    init_counts: np.ndarray      # [S] f32 (seed IUPAC aggregate; int64 wide)
    init_expected: np.ndarray    # [S] f32
    init_bgp: np.ndarray         # [S] f32
    init_score: np.ndarray       # [S] f32 (from the base tables)
    n_steps: int
    overflow: bool


class SeedOutcome(NamedTuple):
    """One seed's replayed walk: print rows + final pattern."""

    rows: List[Tuple[np.ndarray, int, float, float]]  # (digits, n, exp, score)
    emitted: bool
    final_digits: np.ndarray
    final_counts: int
    final_expected: np.float32
    final_bgp: np.float32


# ---------------------------------------------------------------------------
# device: lockstep walks
# ---------------------------------------------------------------------------


def _aggregate_full(stack: torch.Tensor, masks: torch.Tensor, length: int,
                    both: bool) -> torch.Tensor:
    """Aggregate of full IUPAC mask sets over the stacked tables
    (S(m) + S(m_rc) - S(m & m_rc), reference:
    src/iupac_pattern.cpp:410-441).  stack: [G, 4**W]; masks: [..., W, 4]
    broadcast against G (pass [S, 1, W, 4] for [S, G] aggregates)."""
    s1 = ft.sep_sum_flat(stack, masks, length)
    if not both:
        return s1
    mrc = masks.flip(-2, -1)
    s2 = ft.sep_sum_flat(stack, mrc, length)
    s3 = ft.sep_sum_flat(stack, masks * mrc, length)
    return s1 + s2 - s3


def _dense_aggregates(counts_flat, expected_flat, bgp_flat, length: int,
                      both: bool, dtype):
    """The step's aggregates as torch code over the whole table, on any
    device (the CPU path, and the kernel's yardstick on the card): a
    function ``aggregates(digits, letters)`` that gives every walk's C
    mutants' [S, 3, C] (count, expected, bg) sums.

    A mutant differs from its mother at one position p, so the
    double-strand dedup aggregate S(M) + S(M_rc) - S(M & M_rc)
    (reference: src/iupac_pattern.cpp:410-441) needs the mother's
    single-position marginals of mask sets A = M, B = M_rc (terms 1, 2)
    and the (p, W-1-p) pair marginals of C = M & M_rc (term 3: p and its
    mirror always straddle the hi/lo split)."""
    dev = counts_flat.device
    W = length
    AGG = dtype
    stack = torch.stack([counts_flat.to(AGG), expected_flat.to(AGG),
                         bgp_flat.to(AGG)])
    if both:
        stack = torch.where(ft.canonical_mask(W, dev), stack,
                            torch.zeros((), dtype=AGG, device=dev))

    # hi/lo bilinear layout: flat id = hi * 4**half + lo, so the table
    # is a [G, H, L] tensor and a separable-mask aggregate is the
    # bilinear form  kron_hi^T X kron_lo — per step, all mask sets'
    # X-contractions batch into two matmuls (see aggregates below)
    half = W // 2
    Lb = 4 ** half
    X = stack.reshape(3, Lb, Lb)
    dig = np.stack([(np.arange(Lb) >> (2 * p)) & 3
                    for p in range(half)])               # [half, L]
    oh_np = np.zeros((half, 4, Lb))
    for _p in range(half):
        oh_np[_p, dig[_p], np.arange(Lb)] = 1.0
    DIG = upload(dig, dev)
    OH = upload(oh_np, dev, AGG)
    POS_H = torch.arange(half, device=dev)[:, None]      # [half, 1]

    masks_tbl = upload(IUPAC_MASKS, dev, AGG)
    pos_idx = torch.arange(W, device=dev).repeat_interleave(MAXSIM)  # [C]
    mirror = W - 1 - pos_idx                                         # [C]
    pair_lo = torch.minimum(pos_idx, mirror)                         # [C]
    is_low = (pos_idx < half)[None, :, None]                         # [1,C,1]

    def _factors(rows_half):
        """[S, half, 4] per-position rows -> [S, half, L] per-index
        factors.  Mask entries are exactly 0/1, so every kron / cumprod
        below is exact regardless of multiply order."""
        return rows_half[:, POS_H, DIG]

    def _loo(f):
        """Exclusive prefix x suffix products along the position axis:
        leave-one-out kron factors, [S, half, L]."""
        pre = torch.cumprod(f, dim=1)
        suf = torch.cumprod(f.flip(1), dim=1).flip(1)
        one = torch.ones_like(f[:, :1])
        pre_ex = torch.cat([one, pre[:, :-1]], dim=1)
        suf_ex = torch.cat([suf[:, 1:], one], dim=1)
        return pre_ex * suf_ex

    def _marg(Zs, loo_lo, Ys, loo_hi):
        """[S, 3, W, 4] single-position marginals: lo positions from
        the hi-contracted Zs, hi positions from the lo-contracted Ys."""
        return torch.cat([
            torch.einsum("sgl,spl,pal->sgpa", Zs, loo_lo, OH),
            torch.einsum("sgh,sph,pah->sgpa", Ys, loo_hi, OH),
        ], dim=2)

    def aggregates(digits, letters):
        S_ = digits.shape[0]
        m = masks_tbl[digits]                            # [S, W, 4]
        u = masks_tbl[letters]                           # [S, C, 4]

        fA_lo, fA_hi = _factors(m[:, :half]), _factors(m[:, half:])
        if both:
            mf = m.flip(1, 2)                            # B rows (rc set)
            mc = m * mf                                  # C rows (dedup set)
            fB_lo, fB_hi = _factors(mf[:, :half]), _factors(mf[:, half:])
            fC_lo, fC_hi = _factors(mc[:, :half]), _factors(mc[:, half:])

            # hi-side contraction: A/B full krons + C leave-one-out
            # (reversed so slot p pairs global hi position W-1-p with
            # lo position p)
            looC_hi4 = (_loo(fC_hi).flip(1)[:, :, None, :]
                        * OH.flip(0)[None])              # [S, half, 4, H]
            hi_cat = torch.cat([
                torch.prod(fA_hi, dim=1)[:, None],
                torch.prod(fB_hi, dim=1)[:, None],
                looC_hi4.reshape(S_, 4 * half, Lb),
            ], dim=1)                                    # [S, 2+4*half, H]
            Zt = torch.einsum("ghl,skh->sgkl", X, hi_cat)

            lo_cat = torch.stack(
                [torch.prod(fA_lo, dim=1), torch.prod(fB_lo, dim=1)], dim=1)
            Yt = torch.einsum("ghl,skl->sgkh", X, lo_cat)  # [S, 3, 2, H]

            MA = _marg(Zt[:, :, 0], _loo(fA_lo), Yt[:, :, 0], _loo(fA_hi))
            MB = _marg(Zt[:, :, 1], _loo(fB_lo), Yt[:, :, 1], _loo(fB_hi))
            ZC = Zt[:, :, 2:].reshape(S_, 3, half, 4, Lb)
            looC_lo4 = _loo(fC_lo)[:, :, None, :] * OH[None]
            G = torch.einsum("sgpbl,spal->sgpab", ZC, looC_lo4)

            uf = u.flip(-1)
            sidx = torch.arange(S_, device=dev)[:, None]
            s1 = torch.einsum("sgca,sca->sgc", MA[:, :, pos_idx], u)
            s2 = torch.einsum("sgca,sca->sgc", MB[:, :, mirror], uf)
            m_mir = m[sidx, mirror[None, :]]             # [S, C, 4]
            mlo_low, mhi_low = u * m_mir.flip(-1), m_mir * uf
            mask_lo = torch.where(is_low, mlo_low, mhi_low)
            mask_hi = torch.where(is_low, mhi_low, mlo_low)
            s3 = torch.einsum("sgcab,sca,scb->sgc",
                              G[:, :, pair_lo], mask_lo, mask_hi)
            agg = s1 + s2 - s3                           # [S, 3, C]
        else:
            Zt = torch.einsum("ghl,skh->sgkl", X,
                              torch.prod(fA_hi, dim=1)[:, None])
            Yt = torch.einsum("ghl,skl->sgkh", X,
                              torch.prod(fA_lo, dim=1)[:, None])
            MA = _marg(Zt[:, :, 0], _loo(fA_lo), Yt[:, :, 0], _loo(fA_hi))
            agg = torch.einsum("sgca,sca->sgc", MA[:, :, pos_idx], u)

        return agg

    return aggregates


def _seed_aggregates(tables, seed_ids: torch.Tensor, length: int,
                     both: bool, dtype) -> torch.Tensor:
    """The seeds' [S, 3] aggregates of the (count, expected, bg) tables:
    a seed is one k-mer, so under both strands its aggregate is the entry
    of its canonical id (min(id, revcomp(id)); a palindrome's once), on
    the plus strand its own.  Equal to :func:`_aggregate_full` on the
    masked tables bit for bit, with no contraction."""
    ids = seed_ids.to(torch.int64)
    if both:
        rc = torch.zeros_like(ids)
        for p in range(length):
            rc += (3 - ((ids >> (2 * p)) & 3)) << (2 * (length - 1 - p))
        ids = torch.minimum(ids, rc)
    return torch.stack([t[ids].to(dtype) for t in tables], dim=-1)


def climb_aggregates(rows, digits, active, letters, out, ids_read,
                     length: int, both: bool):
    """The mutant aggregates of every active walk into ``out`` [S, 3,
    MAXSIM * W], by one launch of the climb kernel (``csrc/climb.cu``) on
    the current stream: rows [4**W, 4] (count, expected, bg, 0), f32 or
    f64, the plus strand's tables (the kernel keeps canonical ids under
    both strands); digits int64 [S, W]; active bool [S] (an inactive
    walk's rows of ``out`` are left as they are); letters int32
    ``LETTER_TABLE``; out in the rows' dtype; ids_read int64 [1] (adds the
    rows the launch read).  Allocates nothing and waits for
    nothing, so a CUDA graph can hold it.  Raises on a tensor it does not
    take and on a refused launch."""
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"climb kernel: needs a CUDA device, got {dev}")
    S = digits.shape[0]
    want = {
        "rows": (rows, (4 ** length, 4), (F32, torch.float64)),
        "digits": (digits, (S, length), (torch.int64,)),
        "active": (active, (S,), (torch.bool,)),
        "letters": (letters, LETTER_TABLE.shape, (torch.int32,)),
        "out": (out, (S, 3, MAXSIM * length), (rows.dtype,)),
        "ids_read": (ids_read, (1,), (torch.int64,)),
    }
    for name, (t, shape, dtypes) in want.items():
        if (t.device != dev or tuple(t.shape) != tuple(shape)
                or t.dtype not in dtypes or not t.is_contiguous()):
            raise ValueError(
                f"climb kernel: {name} must be contiguous {tuple(shape)} of "
                f"{[str(d) for d in dtypes]} on {dev}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if rows.data_ptr() % 16:
        raise ValueError("climb kernel: rows must be 16-byte aligned")
    lib = build_kernels()
    with on_device(dev):
        err = lib.peng_climb_aggregates(
            rows.data_ptr(), digits.data_ptr(), active.data_ptr(),
            letters.data_ptr(), out.data_ptr(), ids_read.data_ptr(), S,
            length, int(both), int(rows.dtype == torch.float64),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"climb kernel launch failed: CUDA error {err} (W {length}, "
            f"{S} walks)")
    return out


def _kernel_aggregates(counts_flat, expected_flat, bgp_flat, letters,
                       active, length: int, both: bool, dtype):
    """The step's aggregates on a CUDA device, by :func:`climb_aggregates`
    over one [4**W, 4] row table: ``(aggregates, ids_read)``, the function
    :func:`_dense_aggregates` gives and the device count of the table rows
    the kernel read."""
    dev = counts_flat.device
    S = active.shape[0]
    rows = torch.zeros((4 ** length, 4), dtype=dtype, device=dev)
    for g, t in enumerate((counts_flat, expected_flat, bgp_flat)):
        rows[:, g] = t
    out = torch.zeros((S, 3, MAXSIM * length), dtype=dtype, device=dev)
    ids_read = torch.zeros(1, dtype=torch.int64, device=dev)
    build_kernels()  # never inside a graph's capture

    def aggregates(digits, letters_):
        return climb_aggregates(rows, digits, active, letters, out,
                                ids_read, length, both)

    return aggregates, ids_read


_SIDE_STREAMS: dict = {}


def _side_stream(dev) -> "torch.cuda.Stream":
    """The process's one capture stream on a CUDA device, as
    ``torch.cuda.graph`` keeps one: cuBLAS keeps a workspace for every
    stream it has run on, so a new stream a call would leave one behind
    (up to PyTorch's 32 pooled streams, ~1 GB on an H100)."""
    key = torch.device(dev).index
    if key not in _SIDE_STREAMS:
        _SIDE_STREAMS[key] = torch.cuda.Stream(dev)
    return _SIDE_STREAMS[key]


def _lockstep(step, dev):
    """``step`` as the climb's loop runs it on ``dev``.

    Off CUDA, ``step`` itself.  On a CUDA device a step's ~350 small
    kernels go to the card as one CUDA graph: the first call runs
    ``step`` eagerly on a side stream (real work, and the capture's
    warm-up, so that cuBLAS makes its workspace for that stream outside
    the capture); the second captures ``step`` once, with a memory pool
    of its own, and replays it; every later call replays it.  Each
    replay counts in ``climb.graph_steps``.  The graph replays the same
    kernels on the same buffers, so the trace is the eager step's, bit
    for bit.  It lives as long as the returned callable: no graph
    outlives its ``walks_program`` call."""
    if dev.type != "cuda":
        return step
    main = torch.cuda.current_stream(dev)
    side = _side_stream(dev)
    graph = None
    warm = False

    def run():
        nonlocal graph, warm
        with torch.cuda.device(dev):
            if graph is None:
                side.wait_stream(main)
                with torch.cuda.stream(side):
                    if warm:
                        graph = torch.cuda.CUDAGraph()
                        graph.capture_begin(
                            capture_error_mode="thread_local")
                        try:
                            step()
                        finally:
                            graph.capture_end()
                    else:
                        step()
                        warm = True
                main.wait_stream(side)
            if graph is not None:
                graph.replay()
                count("climb.graph_steps")

    return run


def walks_program(
    counts_flat: torch.Tensor,     # [4**W] int32, mirrored counts
    expected_flat: torch.Tensor,   # [4**W] f32
    bgp_flat: torch.Tensor,        # [4**W] f32 (strand-aggregated, order k)
    seed_ids: torch.Tensor,        # [S] int32 base-pattern ids
    n_sequences,                   # f32 scalar
    pseudo_expected,               # f32 scalar
    length: int,
    both: bool,
    score_type: int,
    max_steps: int = MAX_STEPS,
    acc_cap: int = ACC_CAP,
    wide: bool = False,
    plain: bool = False,
):
    """All S walks in lockstep on the tables' device; returns the trace
    as a dict of device tensors (keys of :class:`WalkTrace`).  One host
    sync per step (the loop stops once no walk is active); on a CUDA
    device the mutants' aggregates come from the climb kernel
    (:func:`climb_aggregates`; counters ``climb.kernel_steps``, the steps
    it served, and ``climb.ids``, the table ids it read, both 0 off
    CUDA) and every step after the first replays one CUDA graph
    (:func:`_lockstep`).  Every seed slot is a live walk: seeds are sized
    exactly, so the reference's padding mask (``seed_valid``) has no
    counterpart.  ``plain`` takes the dense torch step on any device (the
    kernel's yardstick on the card)."""
    dev = counts_flat.device
    kernel = dev.type == "cuda" and not plain
    count("climb.graph_steps", 0)
    count("climb.kernel_steps", 0)
    count("climb.ids", 0)
    W = length
    C = W * MAXSIM
    S = seed_ids.shape[0]
    R = acc_cap
    AGG = torch.float64 if wide else F32
    n_sequences = ft._scalar_f32(n_sequences, counts_flat)
    pseudo_expected = ft._scalar_f32(pseudo_expected, counts_flat)

    letter_tbl = upload(LETTER_TABLE, dev)
    sim_tbl = letter_tbl[:, 1:].to(torch.int64)
    lb = upload(np.asarray(LOG_BONFERRONI, dtype=np.float32), dev)
    pos_idx = torch.arange(W, device=dev).repeat_interleave(MAXSIM)  # [C]
    inf = torch.full((), float("inf"), dtype=F32, device=dev)
    # the walks' live flags, which each step updates in place
    active = torch.ones(S, dtype=torch.bool, device=dev)
    if kernel:
        aggregates, ids_read = _kernel_aggregates(
            counts_flat, expected_flat, bgp_flat, letter_tbl, active, W,
            both, AGG)
    else:
        aggregates = _dense_aggregates(
            counts_flat, expected_flat, bgp_flat, W, both, AGG)

    def bonferroni_fold(digit_mat):
        """Sequential f32 fold over positions (the reference adds the
        letter penalties one by one, src/iupac_pattern.cpp:465-468)."""
        b = torch.zeros(digit_mat.shape[:-1], dtype=F32, device=dev)
        for p in range(W):
            b = b + lb[digit_mat[..., p]]
        return b

    def _batched_eval(digits):
        """All C mutants of all S walks: (scores_f32, cnt, exp, bgp,
        letters), each [S, C]."""
        S_ = digits.shape[0]
        cand_letters = sim_tbl[digits].reshape(S_, -1)   # [S, C]
        valid = cand_letters >= 0
        letters = torch.where(valid, cand_letters, 0)
        agg = aggregates(digits, letters)                # [S, 3, C]

        c_c, e_c, b_c = agg[:, 0], agg[:, 1], agg[:, 2]  # [S, C]

        if score_type == 0:
            cand_digits = digits[:, None, :].expand(S_, C, W)
            cand_digits = torch.where(
                torch.arange(W, device=dev)[None, None, :]
                == pos_idx[None, :, None],
                letters[..., None], cand_digits)
            bsum = bonferroni_fold(cand_digits)
        else:
            bsum = torch.zeros((S_, C), dtype=F32, device=dev)
        scores = ft.optimization_scores(
            score_type, c_c, e_c, n_sequences, pseudo_expected, bsum)
        scores = torch.where(valid & ~torch.isnan(scores), scores, inf)
        return scores.to(F32), c_c, e_c, b_c, letters

    # ---- init: seed digits, base-table scores, seed IUPAC aggregates ----
    seed_ids = seed_ids.to(torch.int64)
    digits0 = torch.stack(
        [(seed_ids >> (2 * p)) & 3 for p in range(W)], dim=-1)  # [S, W]
    base_c = counts_flat[seed_ids]
    base_e = expected_flat[seed_ids]
    if score_type == 0:
        init_score = ft.base_log_pvalues_ref(base_c, base_e)
    else:
        init_score = ft.base_optimization_scores(
            score_type, base_c.to(F32), base_e, None,
            n_sequences, pseudo_expected)
    init_score = init_score.to(F32)
    init_agg = _seed_aggregates((counts_flat, expected_flat, bgp_flat),
                                seed_ids, W, both, AGG)  # [S, 3]

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    tr = dict(
        improved=zeros((max_steps, S), torch.bool),
        chosen_idx=zeros((max_steps, S), torch.int32),
        chosen_counts=zeros((max_steps, S), AGG),
        chosen_expected=zeros((max_steps, S), AGG),
        chosen_bgp=zeros((max_steps, S), AGG),
        chosen_score=zeros((max_steps, S), F32),
        acc_idx=zeros((max_steps, S, R), torch.int32),
        acc_counts=zeros((max_steps, S, R), AGG),
        acc_expected=zeros((max_steps, S, R), AGG),
        acc_score=zeros((max_steps, S, R), F32),
        acc_n=zeros((max_steps, S), torch.int32),
    )
    # the walks' state, which each step updates in place (the trace row
    # it writes is t_dev's), so that one CUDA graph serves every step
    digits = digits0
    best_score = init_score.clone()
    overflow = zeros((), torch.bool)
    t_dev = zeros((1,), torch.int64)
    cand_i = torch.arange(C, dtype=torch.int32, device=dev).expand(S, C)
    rows_w = torch.arange(W, device=dev)[None, :]

    def step():
        """One lockstep step of every walk; no host sync."""
        scores, c_c, e_c, b_c, letters = _batched_eval(digits)  # [S, C]

        # running-min accept trace (reference: src/peng.cpp:485-497;
        # strict < keeps the earliest min, as argmin does)
        incl = torch.cummin(scores, dim=1).values
        prev = torch.minimum(
            best_score[:, None],
            torch.cat([inf.expand(S, 1), incl[:, :-1]], dim=1))
        accepted = (scores < prev) & active[:, None]
        best_idx = torch.argmin(scores, dim=1)
        step_min = scores.gather(1, best_idx[:, None])[:, 0]
        improved = (step_min < best_score) & active

        # compact accepted rows into R slots per walk; slot R (dropped)
        # takes every duplicate write
        ranks = torch.cumsum(accepted, dim=1) - 1
        slot = torch.where(accepted, torch.clamp(ranks, max=R), R)

        def compact(vals, dtype):
            return zeros((S, R + 1), dtype).scatter_(1, slot, vals)[:, :R]

        n_acc = accepted.sum(dim=1).to(torch.int32)
        overflow.logical_or_(((n_acc > R) & active).any())

        def pick(arr):
            return arr.gather(1, best_idx[:, None])[:, 0]

        def write(key, row):
            tr[key].index_copy_(0, t_dev, row[None])

        write("improved", improved)
        write("chosen_idx", best_idx.to(torch.int32))
        write("chosen_counts", pick(c_c))
        write("chosen_expected", pick(e_c))
        write("chosen_bgp", pick(b_c))
        write("chosen_score", step_min)
        write("acc_idx", compact(cand_i, torch.int32))
        write("acc_counts", compact(c_c, AGG))
        write("acc_expected", compact(e_c, AGG))
        write("acc_score", compact(scores, F32))
        write("acc_n", torch.where(active, n_acc, 0))

        # chosen mutation / state update
        ch_pos = pos_idx[best_idx]
        digits.copy_(torch.where(
            (rows_w == ch_pos[:, None]) & improved[:, None],
            pick(letters)[:, None], digits))
        best_score.copy_(torch.where(improved, step_min, best_score))
        active.copy_(improved)
        t_dev.add_(1)

    # one span a lockstep step, ending in the step's one host sync: is
    # any walk still active?
    run_step = _lockstep(step, dev)
    t = 0
    go = max_steps > 0 and sync_read(active.any(), bool)
    while go:
        with span("step"):
            run_step()
            if kernel:
                count("climb.kernel_steps")
            t += 1
            go = t < max_steps and sync_read(active.any(), bool)
    overflow = overflow | active.any()  # ran out of steps mid-walk
    if kernel:
        count("climb.ids", sync_read(ids_read, int))

    # in wide mode every count sum is an exact integer in f64 and every
    # decision is already made; the host reads counts as integers and
    # the other floats as f32
    def _cnt(x):
        return torch.round(x).to(torch.int64) if wide else x

    for key in ("chosen_counts", "acc_counts"):
        tr[key] = _cnt(tr[key])
    for key in ("chosen_expected", "chosen_bgp", "acc_expected"):
        tr[key] = tr[key].to(F32)
    tr.update(
        init_counts=_cnt(init_agg[:, 0]),
        init_expected=init_agg[:, 1].to(F32),
        init_bgp=init_agg[:, 2].to(F32), init_score=init_score,
        n_steps=t, overflow=overflow)
    return tr


def run_walks(counts_flat, expected_flat, bgp_flat, seed_ids,
              length: int, both: bool, score_type: int, n_sequences: int,
              pseudo_expected: int, wide: bool = False) -> WalkTrace:
    """Host wrapper: one walk per seed, run on the tables' device, trace
    fetched to the host.  Raises :class:`ClimbOverflow` when a walk
    outruns MAX_STEPS or a step accepts more than ACC_CAP rows, which
    engine.process_gpu turns into EngineFallback: the exact engine reruns
    the job, as in the reference package."""
    dev = counts_flat.device
    ids = upload(np.asarray(seed_ids, dtype=np.int32), dev)
    out = walks_program(
        counts_flat, expected_flat, bgp_flat, ids, np.float32(n_sequences),
        np.float32(pseudo_expected), length, both, score_type,
        max_steps=MAX_STEPS, acc_cap=ACC_CAP, wide=wide)
    with span("fetch"):
        h = {k: (sync_read(v).numpy() if isinstance(v, torch.Tensor) else v)
             for k, v in out.items()}
    steps = int(h["n_steps"])
    if bool(h["overflow"]):
        raise ClimbOverflow(
            f"climb trace capacity exceeded: a walk ran past "
            f"MAX_STEPS={MAX_STEPS} steps or accepted more than "
            f"ACC_CAP={ACC_CAP} rows in one step")
    h["n_steps"], h["overflow"] = steps, False
    return WalkTrace(**h)


# ---------------------------------------------------------------------------
# host: seen-set replay
# ---------------------------------------------------------------------------


class Replay(NamedTuple):
    """The native replay of a walk trace (csrc/replay.cpp): the climb
    section's text, each seed's outcome, and the printed rows (those of
    seed s at ``[row_start[s], row_start[s + 1])``)."""

    text: str
    emitted: np.ndarray          # [S] bool
    final_digits: np.ndarray     # [S, W] int8
    final_counts: np.ndarray     # [S] int64
    final_expected: np.ndarray   # [S] f32
    final_bgp: np.ndarray        # [S] f32
    row_start: np.ndarray        # [S + 1] int64
    row_digits: np.ndarray       # [rows, W] int8
    row_counts: np.ndarray       # [rows] int64
    row_expected: np.ndarray     # [rows] f32
    row_score: np.ndarray        # [rows] f32


def replay(trace: WalkTrace, seed_ids, W: int) -> Replay:
    """Sequential seen-set bookkeeping over the device trajectories
    (reference: src/peng.cpp:450-541), in one native pass that also
    writes the climb rows and the seeds' ``optimization:`` lines as
    ``Peng._print_climb_row`` would.  The reference's exact kill/emit
    decisions; raises OverflowError where 11**W passes 64 bits."""
    rp = Replay(*climb_replay_native(trace, seed_ids, W, SIM_TABLE,
                                     IUPAC_CHARS))
    count("climb.replay_rows", len(rp.row_counts))
    return rp


def replay_walks(trace: WalkTrace, seed_ids, W: int) -> List[SeedOutcome]:
    """:func:`replay` as one outcome per seed, in seed order."""
    rp = replay(trace, seed_ids, W)
    return [SeedOutcome(
        rows=[(rp.row_digits[i], int(rp.row_counts[i]),
               float(rp.row_expected[i]), float(rp.row_score[i]))
              for i in range(rp.row_start[s], rp.row_start[s + 1])],
        emitted=bool(rp.emitted[s]), final_digits=rp.final_digits[s],
        final_counts=int(rp.final_counts[s]),
        final_expected=rp.final_expected[s], final_bgp=rp.final_bgp[s])
        for s in range(len(rp.emitted))]
