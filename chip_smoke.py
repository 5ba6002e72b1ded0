#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (peng_motif_tpu_torch) on the CUDA
cards of one machine: phases 1-13 on card 0, phase 14 over every card.

    python3 chip_smoke.py

Phases, each of which asserts (any failure exits non-zero; nothing is
caught):

  1. device  — each card's name and power limit (nvidia-smi), torch's
               device name and count, and with two cards or more the
               links between them (nvidia-smi topo -m and nvlink
               --status where the machine answers them, and torch's
               peer-access matrix);
  2. build   — the histogram kernel (nvcc, sm_90a) and the native host
               library (g++), from the sources in this checkout;
  3. kernel  — the histogram kernels against their plain PyTorch version
               (torch.bincount), bit-identical, at 50M ids for eight table
               sizes (every tier the dispatcher can take, at full width:
               the shared tier at 384 ... 58,112 bins in one slice and at
               4**8, 4**9 in slices, the L2 tier at 4**10 and in bin-range
               passes at 4**12) and on the edge inputs of
               peng_motif_tpu_torch.bench_histogram (unaligned slices,
               ragged lengths, junk in masked ids, flags of 2 and 255,
               counted ids outside the table, 2**24 inputs in one bin),
               timed with CUDA events beside the bound from the bytes,
               with no flag and with every flag set, and beside the
               library calls (index_add_, bincount);
  4. golden  — the port's device engine (--device cuda --engine tpu) on
               the golden MafK inputs (MafK -w 8, -w 10; MafK_100seqs -w 8,
               -w 12)
               against the reference's MEME files (5e-6 absolute + 1e-6
               relative, identical structure), every 4**W-table phase on
               the device (LAST_CLIMB_ENGINE == LAST_PWM_ENGINE ==
               "device"), with the --timing phase walls and the device
               wall of each post-count program (stats, climb, adv-PWM,
               EM) rerun on the recorded inputs;
  5. scale   — the 51.2-Mbase corpus (25,000 x 2,048 bp, seed 7) through
               the CLI at -w 10, with the kernel and with the plain
               histogram swapped in, in turns (kernel, plain, plain,
               kernel): identical count table, ltot, background counts and
               MEME bytes; the same for the count phase alone at -w 12.
               The kernel is also checked and timed on the exact inputs
               the main path handed it;
  6. chain   — the post-count chain (stats -> climb -> adv-PWM -> EM),
               card against CPU from the same resident state, on the
               MafK -w 10 count (f32 chain) and the 51.2-Mbase -w 10
               count (f64 "wide" chain, ltot >= 2**24): the walk trace's
               integer fields identical, its floats within 1e-6 relative
               (scores 2e-6 + 2e-5), the adv-PWMs bit-identical, the EM
               PWMs within 5e-6 with identical iteration counts; then
               EM's round kernel (csrc/em.cu) against the plain torch
               round on the card, on the EM inputs of MafK jobs at -w 10
               (17 motifs) and -w 12 (16): identical iterations, PWM
               cells within 5e-6, two kernel calls bit-identical, the
               kernel's device time a round (profiler) and both rounds'
               walls a round (in turns) beside the bytes' bound; then
               the climb's aggregates kernel (csrc/climb.cu) against the
               dense torch step on the card, on the walk inputs of MafK
               jobs at -w 10 and -w 12: the trace's integer fields
               identical, aggregates within 1e-6 relative, two kernel
               runs bit-identical, the kernel's device time a step
               (profiler), the rows it read and their bytes' bound;
  7. exact   — the exact engine (--engine exact --device cuda): MafK -w 8,
               -w 10 and MafK_100seqs -w 12 with the host count (within
               tolerance of the golden files; byte-identity printed) and
               with the batch count forced onto the card
               (PENG_COUNT_HOST_MAX_BASES=0: the kernel launches, MEME
               bytes equal the host-count run's); the 51.2-Mbase corpus
               at -w 10, host count against device count in turns
               (identical table, ltot and MEME bytes; the kernel timed
               against the plain version on the ids the main path handed
               it); --engine tpu against --engine exact (51.2 Mbases -w
               10: identical decisions with the float differences
               printed, and with --no-em identical PWM cells — EM's sums
               and the wide climb's f64 aggregates are the parts not in
               the reference binary's order; at -w 12 on
               MafK_100seqs and 51.2 Mbases the walls and the comparison
               are printed, not asserted); a checkpoint saved by the device engine and
               loaded by both engines; one --profile run whose Chrome
               trace holds the histogram kernel;
  8. mesh    — parallel/sharded.py on the card: stream_count_sharded on
               the 51.2-Mbase corpus at -w 10 over four shards that all
               live on the one card, against the mesh of one that is the
               single-device count (table, slice, ltot, suspicion and
               background bit-identical, with the kernel and with the
               plain histogram swapped in; the kernel's launches per
               mesh printed, and the kernel timed on one shard's inputs);
               count_patterns_sharded, count_device_full_sharded and
               count_bg_kmers_sharded on MafK at -w 8 against the
               single-device count and the native scans, the kernel
               timed on one shard's inputs of each; the CLI with
               --devices 1 (51.2 Mbases -w 10 on the device engine, MafK
               -w 8 on the exact engine with the batch count on the
               card): output identical to the run without --devices;
               --devices with one card more than the machine has must
               exit with an error;
  9. procs   — two processes that share card 0 (each started with
               CUDA_VISIBLE_DEVICES naming that card alone;
               python -m peng_motif_tpu_torch ... --num-processes 2, gloo
               expected) on MafK -w 10 and the 51.2-Mbase corpus:
               process 0's MEME equal to the single-process run's, and
               every rank's own report of the chunk rows it counted and
               the kernels it launched for them read from its stderr
               (each rank must have launched on the card; the two blocks
               tile the chunk axis); the kernel held against the plain
               version and timed on one rank's block of the 51.2-Mbase
               corpus, rebuilt in this process; then
               NCCL at world size 1 on card 0, in this process
               (init_multihost + multihost_stream_counts +
               multihost_bg_counts on the 51.2-Mbase corpus): LAST_BACKEND == "nccl", table, ltot
               and background counts equal to the single-device run's;
 10. parity  — the cases of the reference's hardware parity list that
               phase 4 lacks (MafK_100seqs -w 8 with --strand PLUS, with
               LOGPVAL and with ENRICHMENT, MafK_100seqs -w 12, the
               merge-heavy MafK -w 8 -t 5) through --device cuda --engine
               tpu against the golden files (5e-6 + 1e-6 relative; 2e-5
               for the merge-heavy case), every phase on the device and
               the kernel launched; then a 20-Mbase corpus (10,000 x 2,000
               bp, seed 13) at -w 8, device engine against exact engine:
               no fallback, every non-float token of the MEME file and of
               stdout equal, floats within 1e-4 + 1e-5 relative;
 11. entry   — graft_entry.entry() on the card: the output lives on the
               card, one histogram launch (held against the plain version
               and timed on that input), z-scores within 1e-6 of the same
               function on the CPU; then the rank-W tensor ops at W = 8 on
               the MafK count, card against CPU: bg_prob_table +
               aggregate_double_strand bit-identical (and equal to the
               flat table), aggregate_batch counts identical and floats
               within 1e-5 relative, em_optimize iteration counts
               identical and PWMs within 5e-6;
 12. hybrid  — where the count phase counts (ops/hybrid.py): on the
               card or on the host, over the whole corpus.  The count
               phase at either end, in turns, at -w 8, 10, 12 over
               MafK_100seqs, MafK and prefixes of the 51.2-Mbase corpus
               from 8 sequences up: the walls behind the rule's
               crossover, the two ends' rates and fixed costs fitted to
               them, and for each corpus the end the rule takes beside
               the end that was faster.  Then the 51.2-Mbase corpus and
               MafK at -w 10 and MafK_100seqs at -w 12 through the CLI on
               the card, on the host and at the rule's end: count table,
               ltot, background counts, MEME bytes and stdout identical
               across the three, LAST_HYBRID_FRAC as forced or as the
               rule answers (the rule must take the card for the first
               and the host for the last: a default run on each side),
               the kernel launches printed (0 on the host) and the
               kernel held against the plain version on each run's ids;
               job and count-phase walls of the rule's end against the
               card, in turns, medians of eight runs each (four at -w
               12).  The same identity for the count phase alone at 51.2
               Mbases -w 12, where the resident table with its fix-up
               must equal the host table, and there the walls of the
               rule's end, the card and the host in turns;
 13. shoot   — python -m peng_motif_tpu_torch.shoot on MafK_100seqs -w 8
               --no-scoring, on the card and on the CPU: both exit 0, MEME
               and JSON within the engine tolerance of each other;
 14. cards   — the multi-card paths, with two cards or more (meshes of
               2 and of min(cards, 4)); on one card each of its five
               parts prints "not run: 1 card" and the script goes on.
               The sharded stream count over cuda:0… (MafK -w 6, -w 8,
               51.2 Mbases -w 10, -w 12) bit-identical to the mesh of one,
               every card launching, and the kernel held against the plain
               version and timed on the first input of each table size
               that each card counted; count_patterns_sharded,
               count_device_full_sharded and count_bg_kmers_sharded over
               the cards against the host scans and the mesh of one; the
               CLI with --devices (device engine on MafK -w 8, -w 10,
               MafK_100seqs -w 12, 51.2 Mbases -w 10, -w 12: MEME and JSON
               bytes and stdout identical to the run without --devices, no
               launch or allocation on cuda:1… after the count; the exact
               engine with its count on the cards byte-identical to
               golden); multi-process jobs over NCCL on the 51.2-Mbase
               corpus at -w 10, one card a process (four processes) and
               two cards a process (two), each process given its own cards
               by CUDA_VISIBLE_DEVICES (parallel/multihost.card_sets):
               every rank reports backend nccl, the blocks tile the chunk
               axis, process 0's MEME and JSON bytes and stdout equal the
               single-process run's;
               dryrun_multichip over the cards.

Every phase but 12 counts on the card (ops/hybrid.count_on_host patched
to answer False).  The last two lines are the kernels' JSON record and the run's
result,
``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits non-zero before any phase.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import types
from statistics import median

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "golden")
KERNEL_SOURCE = "peng_motif_tpu_torch/csrc/histogram.cu"
KERNEL_REPLACES = "peng_motif_tpu/ops/pallas_hist.py:261"
EM_SOURCE = "peng_motif_tpu_torch/csrc/em.cu"
CLIMB_SOURCE = "peng_motif_tpu_torch/csrc/climb.cu"
TOL_ABS, TOL_REL = 5e-6, 1e-6


@contextlib.contextmanager
def phase(name):
    print(f"[phase] {name} ...", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"[phase] {name} done in {time.perf_counter() - t0:.3f} s",
          flush=True)


def within_tolerance(got: str, want: str, tol_abs=TOL_ABS,
                     tol_rel=TOL_REL) -> bool:
    """Identical line/token structure; numeric tokens within
    tol_abs + tol_rel * |want|, every other token equal."""
    a_lines, b_lines = got.splitlines(), want.splitlines()
    if len(a_lines) != len(b_lines):
        return False
    for a, b in zip(a_lines, b_lines):
        ta, tb = a.split(), b.split()
        if len(ta) != len(tb):
            return False
        for x, y in zip(ta, tb):
            if x == y:
                continue
            try:
                fx, fy = float(x), float(y)
            except ValueError:
                return False
            if fx != fy and not abs(fx - fy) <= tol_abs + tol_rel * abs(fy):
                return False
    return True


def compare_outputs(got: str, want: str):
    """(decisions identical, max absolute difference of the PWM cells,
    max relative difference of the motif-header floats).  Decisions:
    identical line/token structure with every non-numeric and every
    integer token (motif strings, widths, nsites) equal."""
    a_lines, b_lines = got.splitlines(), want.splitlines()
    same, d_cell, d_hdr = len(a_lines) == len(b_lines), 0.0, 0.0
    for a, b in zip(a_lines, b_lines):
        ta, tb = a.split(), b.split()
        same &= len(ta) == len(tb)
        for x, y in zip(ta, tb):
            if x == y:
                continue
            try:
                fx, fy = float(x), float(y)
            except ValueError:
                same = False
                continue
            same &= "." in x + y or "e" in x + y
            if a.startswith("letter-probability"):
                d_hdr = max(d_hdr, abs(fx - fy) / max(abs(fy), 1e-30))
            else:
                d_cell = max(d_cell, abs(fx - fy))
    return same, d_cell, d_hdr


def run_cli(argv, stdout=None):
    """The port's CLI in-process; stdout (the climb log) goes to the
    ``stdout`` stream when given and is discarded otherwise.  Returns
    (wall time in seconds, {phase: ms} of the --timing report when
    ``argv`` asks for it)."""
    from peng_motif_tpu_torch.cli import main

    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout or io.StringIO()), \
            contextlib.redirect_stderr(err):
        rc = main(argv)
    wall = time.perf_counter() - t0
    assert rc == 0, f"CLI exited {rc}: {argv}\n{err.getvalue()}"
    timing = {}
    for line in err.getvalue().splitlines():
        if line.startswith("[TIMING] "):
            name, ms = line[len("[TIMING] "):].rsplit(": ", 1)
            timing[name] = float(ms.split()[0])
    return wall, timing


def time_pair(ids, inc, n_bins, reps=10, library=False):
    """(kernel ms, plain ms, bit-identical, max abs error, library ms) on
    one input, kernel and plain (and, with ``library``, the two library
    calls: the faster one is reported, else None) timed in turns after a
    warm-up."""
    import torch

    from peng_motif_tpu_torch.bench_histogram import (library_calls,
                                                      time_in_turns)
    from peng_motif_tpu_torch.ops import histogram as H

    fns = {"kernel": lambda: H.histogram(ids, inc, n_bins),
           "plain": lambda: H.histogram_plain(ids, inc, n_bins)}
    got, want = fns["kernel"](), fns["plain"]()
    torch.cuda.synchronize()
    same = torch.equal(got, want)
    err = int((got.long() - want.long()).abs().max())
    if library:
        fns.update(library_calls(ids, inc, n_bins))
    ms = time_in_turns(fns, reps)
    lib_ms = min(ms["index_add_"], ms["bincount"]) if library else None
    return ms["kernel"], ms["plain"], same, err, lib_ms


def write_large_corpus(path, n_seq=25_000):
    """The reference bench's 51.2-Mbase corpus (bench.py _gen_large):
    25,000 x 2,048 bp, seed 7, ~30% of sequences carrying one planted
    TGA[C/G]TCAC; with ``n_seq`` rows, the same generator's corpus of
    that many."""
    import numpy as np

    rng = np.random.default_rng(7)
    let = np.frombuffer(b"ACGT", dtype=np.uint8)
    L = 2_048
    rows = let[rng.integers(0, 4, size=(n_seq, L))]
    sel = rng.random(n_seq) < 0.3
    mot_c = np.frombuffer(b"TGACTCAC", dtype=np.uint8)
    mot_g = np.frombuffer(b"TGAGTCAC", dtype=np.uint8)
    pos = rng.integers(0, L - 8, size=n_seq)
    for i in np.flatnonzero(sel):
        rows[i, pos[i] : pos[i] + 8] = mot_c if (i & 1) else mot_g
    with open(path, "wb") as f:
        for i in range(n_seq):
            f.write(b">s%d\n" % i)
            f.write(rows[i].tobytes())
            f.write(b"\n")
    return n_seq * L


class Recorder:
    """Wraps the engine's count phase and the stream count's histogram
    to keep what one run computed: the exact
    count table and ltot, the background counts, the count-phase wall,
    and the first input of each table size handed to the histogram."""

    def __init__(self, plain=False):
        self.plain = plain

    @contextlib.contextmanager
    def active(self):
        from peng_motif_tpu_torch import engine
        from peng_motif_tpu_torch.ops import histogram as H
        from peng_motif_tpu_torch.ops import stream_count

        self.counts = self.ltot = self.bg = None
        self.count_s = 0.0
        self.inputs = {}
        real_phase = engine._count_phase
        real_hist = stream_count.histogram
        hist = H.histogram_plain if self.plain else real_hist

        def count_phase(peng, *a, **k):
            t0 = time.perf_counter()
            out = real_phase(peng, *a, **k)
            self.count_s += time.perf_counter() - t0
            self.counts, self.ltot = out[0], out[1]
            # delivered by the count phase (the fused device histogram
            # or the host count's scan)
            self.bg = [n.copy() for n in peng.bg_model.n]
            return out

        def histogram(ids, inc, n_bins, out=None):
            if n_bins not in self.inputs:
                self.inputs[n_bins] = (ids.clone(), inc.clone())
            return hist(ids, inc, n_bins, out=out)

        engine._count_phase = count_phase
        stream_count.histogram = histogram
        try:
            yield self
        finally:
            engine._count_phase = real_phase
            stream_count.histogram = real_hist


@contextlib.contextmanager
def environ(key, value):
    """``os.environ[key]`` set to ``value`` or, for None, unset."""
    old = os.environ.pop(key, None)
    if value is not None:
        os.environ[key] = str(value)
    try:
        yield
    finally:
        os.environ.pop(key, None)
        if old is not None:
            os.environ[key] = old


def count_on(where):
    """The exact engine's count on the host (the default) or, for
    ``where == "device"``, forced onto the card's batch count
    (PENG_COUNT_HOST_MAX_BASES=0)."""
    return environ("PENG_COUNT_HOST_MAX_BASES",
                   "0" if where == "device" else None)


# ops/hybrid.count_on_host, the rule that picks where the count phase
# counts; main() keeps it here before it pins every phase to the card
RULE = None


@contextlib.contextmanager
def count_end(on_host):
    """The count phase forced onto the host (True) or the card (False)
    by patching ops/hybrid.count_on_host, or left to the rule (None)."""
    from peng_motif_tpu_torch.ops import hybrid

    old = hybrid.count_on_host
    hybrid.count_on_host = (RULE if on_host is None
                            else (lambda *a: on_host))
    try:
        yield
    finally:
        hybrid.count_on_host = old


class ExactRecorder:
    """Wraps the exact engine's count (ops/counting.CountJob) and its
    batch count's histogram to keep what one run computed: the count
    table and ltot, the wall from the count's start to its result, and
    the first input handed to the histogram."""

    @contextlib.contextmanager
    def active(self):
        from peng_motif_tpu_torch.ops import counting

        job_cls = counting.CountJob
        real_init, real_finish = job_cls.__init__, job_cls.finish
        real_hist = counting.histogram
        self.counts = self.ltot = self.hist_input = None
        self.count_s = 0.0
        starts = []

        def init(job, *a, **k):
            starts.append(time.perf_counter())
            real_init(job, *a, **k)

        def finish(job):
            out = real_finish(job)
            self.count_s += time.perf_counter() - starts.pop()
            self.counts, self.ltot = out
            return out

        def histogram(ids, inc, n_bins, out=None):
            if self.hist_input is None:
                self.hist_input = (ids.clone(), inc.clone(), n_bins)
            return real_hist(ids, inc, n_bins, out=out)

        job_cls.__init__, job_cls.finish = init, finish
        counting.histogram = histogram
        try:
            yield self
        finally:
            job_cls.__init__, job_cls.finish = real_init, real_finish
            counting.histogram = real_hist


class ChainRecorder:
    """Wraps the engine's post-count programs to keep the inputs one CLI
    run handed each: the resident state, the seeds, the motif digits and
    the statics.  :meth:`inputs` copies them to the host after the run."""

    NAMES = ("stats_program", "run_walks", "adv_pwm_program",
             "em_optimize_flat")

    @contextlib.contextmanager
    def active(self):
        from peng_motif_tpu_torch import engine

        real = {n: getattr(engine, n) for n in self.NAMES}
        self.calls = {}

        def wrap(name):
            def fn(*a, **k):
                self.calls.setdefault(name, (a, k))
                return real[name](*a, **k)
            return fn

        for n in self.NAMES:
            setattr(engine, n, wrap(n))
        try:
            yield self
        finally:
            for n in self.NAMES:
                setattr(engine, n, real[n])

    def inputs(self):
        import numpy as np

        (state, W, k, kmax, both), _ = self.calls["stats_program"]
        a, kw = self.calls["run_walks"]
        inp = dict(
            counts=state.counts.cpu().numpy(), ltot=state.ltot,
            fix_ids=state.fix_ids.cpu().numpy(),
            fix_dv=state.fix_dv.cpu().numpy(),
            v=[x.cpu().numpy() for x in state.v], stats=(W, k, kmax, both),
            seeds=list(a[3]), walks=a[4:9], wide=kw["wide"], adv=None,
            em=None)
        if "adv_pwm_program" in self.calls:
            a, _ = self.calls["adv_pwm_program"]
            inp["adv"] = (np.asarray(a[0]), a[3])
        if "em_optimize_flat" in self.calls:
            a, _ = self.calls["em_optimize_flat"]
            inp["em"] = a[3:6]
        return inp


def run_chain(inp, dev):
    """stats -> climb -> adv-PWM -> EM on ``dev`` from recorded inputs:
    ({program: synchronized wall s}, {output: host arrays})."""
    import torch

    from peng_motif_tpu_torch import engine
    from peng_motif_tpu_torch.ops import climb, em
    from peng_motif_tpu_torch.utils.logging_utils import PhaseTimer

    dev = torch.device(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    walls, out = {}, {}
    state = engine.resident_state(inp["counts"], inp["ltot"],
                                  inp["fix_ids"], inp["fix_dv"], inp["v"],
                                  dev)
    W, _k, _kmax, both = inp["stats"]
    sync()
    t0 = time.perf_counter()
    st = engine.stats_program(state, *inp["stats"])
    sync()
    walls["stats"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with PhaseTimer().activate() as recorder:
        out["trace"] = climb.run_walks(
            st["counts"], st["expected"], st["bgp"], inp["seeds"],
            *inp["walks"], wide=inp["wide"])
    walls["climb"] = time.perf_counter() - t0   # the trace fetch syncs
    out["walk_stats"] = dict(seeds=len(inp["seeds"]),
                             steps=recorder.calls("step"))
    if inp["adv"] is not None:
        digit_mat, pseudo = inp["adv"]
        sync()
        t0 = time.perf_counter()
        pwm0 = engine.adv_pwm_program(torch.from_numpy(digit_mat),
                                      st["counts"], state.v[0], pseudo, W,
                                      both, wide=inp["wide"])
        sync()
        walls["adv_pwm"] = time.perf_counter() - t0
        out["pwm0"] = pwm0.cpu().numpy()
        if inp["em"] is not None:
            t0 = time.perf_counter()
            final, iters = em.em_optimize_flat(pwm0, st["counts"],
                                               st["bg_max"], *inp["em"], W)
            sync()
            walls["em"] = time.perf_counter() - t0
            out["em"] = (final.cpu().numpy(), iters.cpu().numpy())
    return walls, out


def run_em_phase(tmp, dev):
    """Phase 6's EM half: the round kernel against the plain torch round
    on the inputs of MafK jobs at the cells' widths.  Returns the numbers
    by width for the kernels' JSON record."""
    import numpy as np
    import torch

    from peng_motif_tpu_torch import engine
    from peng_motif_tpu_torch.ops import em

    fns = {"kernel": em.em_optimize_flat_kernel,
           "plain": em.em_optimize_flat_plain}
    out = {}
    with phase("em: the round kernel against the plain torch round"):
        for W in (10, 12):
            calls = []
            real = engine.em_optimize_flat

            def record(*a, calls=calls, real=real):
                calls.append(a)
                return real(*a)

            engine.em_optimize_flat = record
            try:
                run_cli([os.path.join(GOLDEN, "MafK.fasta"), "-w", str(W),
                         "--device", "cuda", "--engine", "tpu", "-o",
                         os.path.join(tmp, f"em_w{W}.meme")])
            finally:
                engine.em_optimize_flat = real
            (args,) = calls
            assert args[0].device.type == "cuda" and args[-1] == W
            res, walls = {}, {"kernel": [], "plain": []}
            # the first run of each is a warm-up; then kernel, plain,
            # plain, kernel
            for label in ("kernel", "plain", "kernel", "plain", "plain",
                          "kernel"):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                pwm, it = fns[label](*args)
                torch.cuda.synchronize(dev)
                wall = time.perf_counter() - t0
                if label in res:
                    walls[label].append(wall)
                    if label == "kernel":
                        assert torch.equal(pwm, res[label][0]), \
                            f"w{W}: two kernel calls differ"
                res.setdefault(label, (pwm, it))
            (kp, ki), (pp, pi) = res["kernel"], res["plain"]
            assert torch.equal(ki, pi), f"w{W}: EM iterations differ"
            err = float((kp - pp).abs().max())
            assert err <= TOL_ABS, f"w{W}: EM PWMs {err} apart"
            rounds = int(ki.max())
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                em.em_optimize_flat_kernel(*args)
                torch.cuda.synchronize(dev)
            device_us = {"em_round_kernel": 0.0, "em_tail_kernel": 0.0}
            for e in prof.key_averages():
                for name in device_us:
                    if name in e.key:
                        device_us[name] += e.device_time_total
            bound_ms = 8 * 4 ** W / 3.35e12 * 1e3
            rec = dict(
                motifs=int(args[0].shape[0]), rounds=rounds,
                iterations=ki.tolist(), max_abs_err=err,
                kernel_wall_ms=median(walls["kernel"]) * 1e3 / rounds,
                plain_wall_ms=median(walls["plain"]) * 1e3 / rounds,
                kernel_device_ms={k: v / 1e3 / rounds
                                  for k, v in device_us.items()},
                bound_ms=bound_ms)
            dev_ms = sum(rec["kernel_device_ms"].values())
            print(f"  w{W}: {rec['motifs']} motifs, {rounds} rounds "
                  f"{rec['iterations']}; a round: kernel "
                  f"{rec['kernel_wall_ms']:.4f} ms wall (device: round "
                  f"{rec['kernel_device_ms']['em_round_kernel']:.4f} + tail "
                  f"{rec['kernel_device_ms']['em_tail_kernel']:.4f} ms, "
                  f"{100 * bound_ms / dev_ms:.1f}% of the {bound_ms:.4f} ms "
                  f"bound of 8 B an id), plain torch round "
                  f"{rec['plain_wall_ms']:.4f} ms wall; PWMs within "
                  f"{err:.3g}, iterations identical", flush=True)
            assert dev_ms > 0, f"w{W}: the profiler saw no EM kernel"
            out[f"w{W}"] = rec
    return out


def run_climb_phase(tmp, dev):
    """Phase 6's climb half: the aggregates kernel against the dense torch
    step on the walk inputs of MafK jobs at the cells' widths.  Returns
    the numbers by width for the kernels' JSON record."""
    import numpy as np
    import torch

    from peng_motif_tpu_torch import engine
    from peng_motif_tpu_torch.ops import climb
    from peng_motif_tpu_torch.utils.logging_utils import PhaseTimer

    out = {}
    with phase("climb: the aggregates kernel against the dense torch step"):
        for W in (10, 12):
            calls = []
            real = engine.run_walks

            def record(*a, calls=calls, real=real, **k):
                calls.append((a, k))
                return real(*a, **k)

            engine.run_walks = record
            try:
                run_cli([os.path.join(GOLDEN, "MafK.fasta"), "-w", str(W),
                         "--device", "cuda", "--engine", "tpu", "-o",
                         os.path.join(tmp, f"climb_w{W}.meme")])
            finally:
                engine.run_walks = real
            ((a, kw),) = calls
            counts, expected, bgp, seeds, length, both, st, n_seq, pseudo = a
            assert counts.device.type == "cuda" and length == W
            ids = torch.as_tensor(np.asarray(seeds, np.int32), device=dev)

            def walks(plain):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                with PhaseTimer().activate() as rec:
                    tr = climb.walks_program(
                        counts, expected, bgp, ids, np.float32(n_seq),
                        np.float32(pseudo), length, both, st, plain=plain,
                        **kw)
                torch.cuda.synchronize(dev)
                return tr, rec, time.perf_counter() - t0

            res, walls = {}, {"kernel": [], "plain": []}
            # the first run of each is a warm-up; then kernel, plain,
            # plain, kernel
            for label in ("kernel", "plain", "kernel", "plain", "plain",
                          "kernel"):
                tr, rec, wall = walks(label == "plain")
                if label in res:
                    walls[label].append(wall)
                    if label == "kernel":
                        for k, x in tr.items():
                            if torch.is_tensor(x):
                                assert torch.equal(x, res[label][0][k]), \
                                    f"w{W}: two kernel runs differ in {k}"
                res.setdefault(label, (tr, rec))
            (kt, krec), (pt, _) = res["kernel"], res["plain"]
            h = {lab: {k: (x.cpu().numpy() if torch.is_tensor(x) else x)
                       for k, x in t.items()}
                 for lab, t in (("kernel", kt), ("plain", pt))}
            steps = int(h["kernel"]["n_steps"])
            assert steps == int(h["plain"]["n_steps"]) >= 2
            for k in ("improved", "chosen_idx", "acc_idx", "acc_n",
                      "chosen_counts", "acc_counts", "init_counts"):
                assert np.array_equal(h["kernel"][k], h["plain"][k]), \
                    f"w{W}: walk traces differ in {k}"
            rel = 0.0
            for k in ("chosen_expected", "chosen_bgp", "acc_expected",
                      "init_expected", "init_bgp"):
                x = h["kernel"][k].astype(np.float64)
                y = h["plain"][k].astype(np.float64)
                scale = np.where(y != 0, np.abs(y), 1.0)
                rel = max(rel, float(np.max(np.abs(x - y) / scale)))
            assert rel <= 1e-6, f"w{W}: aggregates {rel} apart"
            assert krec.counters["climb.kernel_steps"] == steps
            rows = krec.counters["climb.ids"]
            assert rows > 0
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                walks(False)
            device_us = sum(e.device_time_total for e in prof.key_averages()
                            if "climb_agg_kernel" in e.key)
            assert device_us > 0, f"w{W}: the profiler saw no climb kernel"
            # |M|, the k-mers of a walk's pattern, at each step it was
            # active, replayed from the trace
            sizes = np.asarray(climb.IUPAC_MASKS).sum(1)
            digits = [[(int(x) >> (2 * p)) & 3 for p in range(W)]
                      for x in seeds]
            live = [True] * len(seeds)
            set_sizes = {}
            for t in range(steps):
                for s_, d in enumerate(digits):
                    if not live[s_]:
                        continue
                    m = int(np.prod(sizes[d]))
                    set_sizes[m] = set_sizes.get(m, 0) + 1
                    live[s_] = bool(h["kernel"]["improved"][t, s_])
                    if live[s_]:
                        p, j = divmod(int(h["kernel"]["chosen_idx"][t, s_]),
                                      climb.MAXSIM)
                        d[p] = int(climb.SIM_TABLE[d[p], j])
            row_bytes = 32 if kw["wide"] else 16
            rec = dict(
                set_sizes=dict(sorted(set_sizes.items())),
                walks=len(seeds), steps=steps, ids_read=rows,
                bytes=rows * row_bytes, max_rel_err=rel,
                kernel_device_ms=device_us / 1e3 / steps,
                kernel_wall_ms=median(walls["kernel"]) * 1e3 / steps,
                plain_wall_ms=median(walls["plain"]) * 1e3 / steps,
                bound_ms=rows * row_bytes / 3.35e12 * 1e3 / steps)
            print(f"  w{W}: {rec['walks']} walks, {steps} steps, "
                  f"{rows} rows read ({rec['bytes'] / 1e6:.1f} MB); a step: "
                  f"kernel {rec['kernel_device_ms']:.4f} ms device "
                  f"({100 * rec['bound_ms'] / rec['kernel_device_ms']:.1f}% "
                  f"of the {rec['bound_ms']:.4f} ms bound of its rows' bytes "
                  f"at 3.35 TB/s), walks {rec['kernel_wall_ms']:.4f} ms "
                  f"wall against the dense step's "
                  f"{rec['plain_wall_ms']:.4f}; trace integers identical, "
                  f"aggregates within {rel:.3g}", flush=True)
            print(f"  w{W}: |M| over the walks' steps: {rec['set_sizes']}",
                  flush=True)
            out[f"w{W}"] = rec
    return out


def fmt_walls(walls):
    return ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in walls.items())


def compare_chains(got, want):
    """Card (``got``) against CPU (``want``): the contract of phase 6."""
    import numpy as np

    a, b = got["trace"], want["trace"]
    assert a.n_steps == b.n_steps and a.overflow == b.overflow
    for k in ("improved", "chosen_idx", "acc_idx", "acc_n", "chosen_counts",
              "acc_counts", "init_counts"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    for k in ("chosen_expected", "chosen_bgp", "acc_expected",
              "init_expected", "init_bgp"):
        np.testing.assert_allclose(getattr(a, k), getattr(b, k), rtol=1e-6,
                                   err_msg=k)
    for k in ("chosen_score", "acc_score", "init_score"):
        np.testing.assert_allclose(getattr(a, k), getattr(b, k), rtol=2e-6,
                                   atol=2e-5, err_msg=k)
    assert ("pwm0" in got) == ("pwm0" in want)
    if "pwm0" in got:
        assert np.array_equal(got["pwm0"], want["pwm0"]), "adv-PWM differs"
    if "em" in got:
        assert np.array_equal(got["em"][1], want["em"][1]), "EM iterations"
        np.testing.assert_allclose(got["em"][0], want["em"][0], rtol=0,
                                   atol=5e-6, err_msg="EM PWMs")


def same_record(a, b):
    import numpy as np

    return (np.array_equal(a.counts, b.counts) and a.ltot == b.ltot
            and len(a.bg) == len(b.bg)
            and all(np.array_equal(x, y) for x, y in zip(a.bg, b.bg)))


def decisions(log: str):
    """The decision lines of a run's stdout: each seed's climb result,
    the filter's selection and the merges."""
    return [ln for ln in log.splitlines() if ln.startswith(
        ("optimization:", "selected iupac pattern:", "merge:"))]


def compare_engines(label, tpu, exact):
    """Print how the device engine's run ``tpu`` and the exact engine's
    run ``exact`` (each (MEME bytes, stdout)) compare; returns (same
    decisions, max PWM-cell difference)."""
    a, b = tpu[0].decode(), exact[0].decode()
    same, d_cell, d_hdr = compare_outputs(a, b)
    dec_a, dec_b = decisions(tpu[1]), decisions(exact[1])
    n_diff = sum(x != y for x, y in zip(dec_a, dec_b)) + abs(
        len(dec_a) - len(dec_b))
    same &= n_diff == 0
    print(f"  {label}, tpu vs exact: decisions identical {same} "
          f"({n_diff} of {len(dec_b)} decision lines differ), within "
          f"tolerance {within_tolerance(a, b)}, byte-identical {a == b}, "
          f"max PWM-cell difference {d_cell:.3g}, max header difference "
          f"{d_hdr:.3g} relative", flush=True)
    return same, d_cell


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def run_exact_phase(tmp, large_fasta):
    """Phase 7 (see the module docstring).  Returns the exact engine's
    batch-count kernel record: launches in its main-path run, kernel and
    plain ms on that run's histogram input, max abs error."""
    import numpy as np

    from peng_motif_tpu_torch import engine
    from peng_motif_tpu_torch.bench_histogram import bound_ms
    from peng_motif_tpu_torch.ops import histogram as H

    rec = {"max_abs_err": 0}

    def cli(argv, out):
        log = io.StringIO()
        wall, timing = run_cli(argv + ["--device", "cuda", "--timing", "-o",
                                       out], log)
        return wall, timing, read_bytes(out), log.getvalue()

    def fmt(timing):
        return ", ".join(f"{k} {v:.1f} ms" for k, v in timing.items())

    with phase("exact engine: golden inputs, host and device count"):
        host_memes = {}
        cases = [("mafk_w8", "MafK.fasta", "8"),
                 ("mafk_w10", "MafK.fasta", "10"),
                 ("mafk100_w12", "MafK_100seqs.fasta", "12")]
        for where in ("host", "device"):
            for stem, fa, w in cases:
                before = H.LAUNCHES
                with count_on(where):
                    wall, timing, got, _ = cli(
                        [os.path.join(GOLDEN, fa), "-w", w, "--engine",
                         "exact"], os.path.join(tmp, f"{stem}_{where}.meme"))
                n = H.LAUNCHES - before
                want = read_bytes(os.path.join(GOLDEN, f"{stem}.meme"))
                assert engine.LAST_ENGINE_USED == "exact"
                print(f"  {stem} {where} count: wall {wall:.3f} s, "
                      f"byte-identical to golden {got == want}, histogram "
                      f"launches {n}; --timing: {fmt(timing)}", flush=True)
                if where == "host":
                    assert within_tolerance(got.decode(), want.decode()), \
                        f"{stem}: exact engine outside the tolerance"
                    assert n == 0, f"{stem}: host count launched the kernel"
                    host_memes[stem] = got
                else:
                    assert n > 0, f"{stem}: device count launched no kernel"
                    assert got == host_memes[stem], \
                        f"{stem}: device-count MEME != host-count MEME"

    with phase("exact engine: 51.2 Mbases -w 10, host vs device count"):
        recs, memes, logs, walls = {}, {}, {}, {"host": [], "device": []}
        for where in ("host", "device", "device", "host"):
            r = ExactRecorder()
            with count_on(where), r.active():
                if where == "device" and "launches" not in rec:
                    H.LAUNCHES = 0  # the exact engine's main-path run
                wall, timing, got, log = cli(
                    [large_fasta, "-w", "10", "--engine", "exact"],
                    os.path.join(tmp, f"exact_large_{where}.meme"))
                if where == "device" and "launches" not in rec:
                    rec["launches"] = H.LAUNCHES
            assert engine.LAST_ENGINE_USED == "exact"
            assert memes.setdefault(where, got) == got
            logs.setdefault(where, log)
            recs.setdefault(where, r)
            walls[where].append(wall)
            print(f"  w10 {where:>6} count: wall {wall:.3f} s, count "
                  f"{r.count_s:.3f} s, ltot {r.ltot}; --timing: "
                  f"{fmt(timing)}", flush=True)
        for where, ws in walls.items():
            print(f"  w10 {where:>6} count, mean of 2: wall "
                  f"{sum(ws) / len(ws):.3f} s", flush=True)
        print(f"  w10 exact-engine main-path histogram launches: "
              f"{rec['launches']}", flush=True)
        assert rec["launches"] > 0, "the exact engine launched no kernel"
        assert np.array_equal(recs["host"].counts, recs["device"].counts)
        assert recs["host"].ltot == recs["device"].ltot
        assert memes["host"] == memes["device"], "w10: MEME bytes differ"
        print("  w10 host vs device count: count table, ltot and MEME bytes "
              "identical", flush=True)
        ids, inc, n_bins = recs["device"].hist_input
        k_ms, p_ms, same, err, lib_ms = time_pair(ids, inc, n_bins,
                                                  library=True)
        b_ms = bound_ms(ids.numel(), n_bins)
        rec.update(ms=k_ms, plain_ms=p_ms, max_abs_err=err,
                   library_ms=lib_ms, bound_ms=b_ms)
        print(f"  batch-count input n_bins={n_bins} n={ids.numel()} "
              f"counted={int(inc.sum())}: kernel {k_ms:.4f} ms "
              f"({100 * b_ms / k_ms:.1f}% of the {b_ms:.4f} ms bound), "
              f"plain {p_ms:.4f} ms, library {lib_ms:.4f} ms, "
              f"bit-identical {same}", flush=True)
        assert same, "kernel != plain on the exact engine's input"
        del ids, inc, recs
        # the device engine against the exact engine.  Two of its sums
        # are not the reference binary's: EM (the native EM folds each
        # PWM cell over 4**W/4 ids in ascending order in f32, the device
        # sums in tree order) and, at ltot >= 2**24, the climb's f64
        # aggregates (the native folds them in f32), which move the
        # motifs' log(Pval) by a few f32 ulps of their expected counts
        # times nsites.  So the decisions are held identical, the float
        # differences printed, and with --no-em every PWM cell identical.
        runs = {}
        for em in ("", "--no-em"):
            for eng in ("tpu", "exact"):
                if eng == "exact" and not em:
                    runs[eng, em] = memes["host"], logs["host"]
                    continue
                _, timing, got, log = cli(
                    [large_fasta, "-w", "10", "--engine", eng]
                    + ([em] if em else []),
                    os.path.join(tmp, f"cmp_{eng}{em}.meme"))
                runs[eng, em] = got, log
                print(f"  w10 {em} --engine {eng}: --timing: {fmt(timing)}",
                      flush=True)
        same, _ = compare_engines("w10", runs["tpu", ""], runs["exact", ""])
        assert same, "w10: the engines' decisions differ"
        same, d_cell = compare_engines("w10 --no-em", runs["tpu", "--no-em"],
                                       runs["exact", "--no-em"])
        assert same and d_cell == 0, "w10 --no-em: the engines' PWMs differ"

    with phase("exact engine: W = 12, device engine vs exact engine"):
        for label, fa in (("mafk100_w12",
                           os.path.join(GOLDEN, "MafK_100seqs.fasta")),
                          ("large_w12", large_fasta)):
            runs, walls = {}, {"tpu": [], "exact": []}
            for eng in ("tpu", "exact", "exact", "tpu"):
                wall, timing, got, log = cli(
                    [fa, "-w", "12", "--engine", eng],
                    os.path.join(tmp, f"{label}_{eng}.meme"))
                assert engine.LAST_ENGINE_USED == (
                    "gpu" if eng == "tpu" else "exact")
                runs.setdefault(eng, (got, log))
                walls[eng].append(wall)
                print(f"  {label} --engine {eng:>5}: wall {wall:.3f} s; "
                      f"--timing: {fmt(timing)}", flush=True)
            print(f"  {label}: walls tpu {walls['tpu']}, exact "
                  f"{walls['exact']}", flush=True)
            compare_engines(label, runs["tpu"], runs["exact"])

    with phase("checkpoint round trip and --profile"):
        mafk = os.path.join(GOLDEN, "MafK.fasta")
        ck = os.path.join(tmp, "ckpt")
        golden = read_bytes(os.path.join(GOLDEN, "mafk_w8.meme"))
        _, _, saved, _ = cli([mafk, "-w", "8", "--engine", "tpu",
                           "--save-checkpoint", ck],
                          os.path.join(tmp, "ck_save.meme"))
        assert engine.LAST_ENGINE_USED == "gpu"
        before = H.LAUNCHES
        _, _, loaded, _ = cli([mafk, "-w", "8", "--engine", "tpu",
                            "--load-checkpoint", ck],
                           os.path.join(tmp, "ck_tpu.meme"))
        assert engine.LAST_ENGINE_USED == "gpu"
        assert H.LAUNCHES == before, "a resumed run counted the input"
        assert within_tolerance(loaded.decode(), golden.decode())
        _, _, exact, _ = cli([mafk, "-w", "8", "--engine", "exact",
                           "--load-checkpoint", ck],
                          os.path.join(tmp, "ck_exact.meme"))
        assert engine.LAST_ENGINE_USED == "exact"
        assert exact == host_memes["mafk_w8"], "exact resume != exact run"
        print(f"  saved by --engine tpu; loaded by tpu: within tolerance, "
              f"identical to the saving run {loaded == saved}; loaded by "
              f"exact: identical to the exact run", flush=True)
        trace_dir = os.path.join(tmp, "trace")
        wall, _, _, _ = cli([mafk, "-w", "8", "--engine", "tpu", "--profile",
                          trace_dir], os.path.join(tmp, "profiled.meme"))
        with open(os.path.join(trace_dir, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        hist = [e for e in kernels if "hist_" in e.get("name", "")]
        busy_us = sum(e.get("dur", 0) for e in kernels)
        print(f"  --profile MafK -w 8 --engine tpu: wall {wall:.3f} s, "
              f"{len(events)} trace events, {len(kernels)} kernels "
              f"({busy_us / 1e3:.3f} ms), histogram kernels {len(hist)}: "
              f"{sorted({e['name'] for e in hist})}", flush=True)
        assert hist, "the profiler trace holds no histogram kernel"
    return rec


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def stream_histogram(fn):
    """``fn(real, ids, inc, n_bins, out)`` in place of the histogram the
    stream count calls (ops/stream_count.histogram)."""
    from peng_motif_tpu_torch.ops import stream_count

    real = stream_count.histogram
    stream_count.histogram = lambda ids, inc, n_bins, out=None: fn(
        real, ids, inc, n_bins, out)
    try:
        yield
    finally:
        stream_count.histogram = real


def run_mesh_phase(tmp, large_fasta, dev, n_bases):
    """Phase 8 (see the module docstring).  Returns the record of the
    sharded call sites for the kernels line."""
    import numpy as np
    import torch

    from peng_motif_tpu_torch import engine
    from peng_motif_tpu_torch.bench_histogram import bound_ms
    from peng_motif_tpu_torch.io.fasta import load_sequence_set
    from peng_motif_tpu_torch.models.background import count_kmers
    from peng_motif_tpu_torch.ops import counting
    from peng_motif_tpu_torch.ops import histogram as H
    from peng_motif_tpu_torch.parallel import sharded
    from peng_motif_tpu_torch.parallel.dryrun import dryrun_multichip

    rec = {"max_abs_err": 0}
    W, both, bg_order = 10, True, 2

    with phase("mesh on the card: stream_count_sharded, 51.2 Mbases -w 10"):
        sset = load_sequence_set(large_fasta)
        flat, n_undef = sset._flat_codes, sset.n_undefined
        # the mesh of one is the single-device count of the main path
        meshes = {"mesh1": (dev,), "mesh4": (dev,) * 4}

        def count(mesh):
            return sharded.stream_count_sharded(
                sset.sequences, W, both, mesh, flat_codes=flat,
                bg_order=bg_order, n_undefined=n_undef)

        outs, walls, shard_inputs = {}, {}, {}
        for version in ("kernel", "plain", "plain", "kernel"):
            for label, mesh in meshes.items():
                first = (version, label) not in outs
                seen = {}

                def hist(real, ids, inc, n_bins, out, seen=seen):
                    if first and version == "kernel" and n_bins not in seen:
                        seen[n_bins] = (ids.clone(), inc.clone())
                    fn = real if version == "kernel" else H.histogram_plain
                    return fn(ids, inc, n_bins, out=out)

                zero_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with stream_histogram(hist):
                    _stream, lay, out = count(mesh)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                walls.setdefault((version, label), []).append(wall)
                if not first:
                    continue
                outs[version, label] = (lay, [t.cpu() for t in out])
                if version == "kernel":
                    rec[f"{label}_launches"] = H.LAUNCHES
                    rec[f"{label}_tier_launches"] = dict(H.TIER_LAUNCHES)
                    shard_inputs[label] = seen
                    print(f"  {label}: m_pad {lay.m_pad}, histogram launches "
                          f"{H.LAUNCHES} {dict(H.TIER_LAUNCHES)}", flush=True)
                else:
                    assert H.LAUNCHES == 0, "the plain run launched a kernel"
        for (version, label), ws in walls.items():
            mean = sum(ws) / len(ws)
            print(f"  {label:>6} {version:>6} histogram: count wall {ws} s, "
                  f"mean {mean:.4f} s = {n_bases / mean / 1e6:.2f} Mbases/s",
                  flush=True)
        # every shard launches both kernels: the background table goes to
        # the shared tier, the 4**10 table to the L2 tier
        assert rec["mesh4_tier_launches"] == {"shared": 4, "l2": 4}, rec
        # seven slabs of 16,384 chunks, both tables per slab
        assert rec["mesh1_tier_launches"] == {"shared": 7, "l2": 7}, rec
        lay1, want = outs["kernel", "mesh1"]
        assert lay1.m_pad == 7 * 16384, lay1.m_pad
        assert int(want[2]) > 0
        for key, (lay, got) in outs.items():
            assert lay.m_pad >= lay1.m_pad and lay.m == lay1.m
            for name, a, b in zip(("counts", "vals", "ltot", "susp", "bg"),
                                  got, want):
                if name == "susp":
                    assert not a[lay1.m_pad:].any(), key
                    a = a[: lay1.m_pad]
                assert torch.equal(a, b), f"{key}: {name} differs"
        print("  mesh of 1 and mesh of 4, kernel and plain: count "
              "table, canonical slice, ltot, suspicion and background counts "
              "bit-identical", flush=True)
        del outs

        # the kernel on the inputs one shard of the mesh of 4 handed it
        for n_bins, (ids, inc) in sorted(shard_inputs["mesh4"].items()):
            k_ms, p_ms, same, err, lib_ms = time_pair(ids, inc, n_bins,
                                                      library=True)
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            b_ms = bound_ms(ids.numel(), n_bins)
            print(f"  mesh4 shard 0 input n_bins={n_bins} n={ids.numel()} "
                  f"counted={int(inc.sum())}: kernel {k_ms:.4f} ms "
                  f"({100 * b_ms / k_ms:.1f}% of the {b_ms:.4f} ms bound), "
                  f"plain {p_ms:.4f} ms, library {lib_ms:.4f} ms, "
                  f"bit-identical {same}", flush=True)
            assert same, f"kernel != plain on the shard's input {n_bins}"
            tag = "shard_table" if n_bins == 4 ** W else "shard_bg"
            rec[tag] = dict(n=ids.numel(), n_bins=n_bins, ms=k_ms,
                            plain_ms=p_ms, library_ms=lib_ms, bound_ms=b_ms)
        assert {"shard_table", "shard_bg"} <= set(rec)
        del shard_inputs, sset, flat

    with phase("mesh on the card: batch and background counts, MafK -w 8"):
        ss = load_sequence_set(os.path.join(GOLDEN, "MafK.fasta"))
        codes = ss.padded()
        mesh = (dev,) * 4
        host = counting.CountJob(codes, 8, both, "cpu").finish()
        seen = []
        real_hist = counting.histogram

        def rec_hist(ids, inc, n_bins, out=None):
            seen.append((ids.clone(), inc.clone(), n_bins))
            return real_hist(ids, inc, n_bins, out=out)

        counting.histogram = rec_hist
        try:
            # the whole batch on the card, then four shards of it
            zero_launches()
            single, single_ltot = counting.count_patterns(
                torch.from_numpy(codes).to(dev), 8, both)
            rec["count_patterns_launches"] = H.LAUNCHES
            zero_launches()
            got, got_ltot = sharded.count_patterns_sharded(codes, 8, both,
                                                           mesh)
        finally:
            counting.histogram = real_hist
        rec["batch_launches"] = H.LAUNCHES
        assert rec["count_patterns_launches"] == 1 and len(seen) == 5
        assert H.LAUNCHES == 4, "a shard of the batch count launched nothing"
        assert np.array_equal(got, host[0]) and got_ltot == host[1]
        assert np.array_equal(got, single.cpu().numpy())
        assert got_ltot == single_ltot
        full = sharded.count_device_full_sharded(codes, 8, both, mesh)
        assert full[0].device == dev and int(full[2]) == int(
            counting._count_device(torch.from_numpy(codes).to(dev), 8,
                                   both)[1])
        bg_seen = []
        real_hist = sharded.histogram

        def rec_bg_hist(ids, inc, n_bins, out=None):
            bg_seen.append((ids.clone(), inc.clone(), n_bins))
            return real_hist(ids, inc, n_bins, out=out)

        zero_launches()
        lengths = np.array([len(s) for s in ss.sequences], dtype=np.int32)
        sharded.histogram = rec_bg_hist
        try:
            bg = sharded.count_bg_kmers_sharded(codes, 2, mesh,
                                                lengths=lengths)
        finally:
            sharded.histogram = real_hist
        rec["bg_launches"] = H.LAUNCHES
        assert len(bg_seen) == 12
        assert H.LAUNCHES == 12, "4 shards x 3 orders of background counts"
        for g, w in zip(bg, count_kmers(ss.sequences, 2)):
            assert np.array_equal(g, w), "sharded background counts differ"
        print(f"  count_patterns_sharded (4 shards, {rec['batch_launches']} "
              f"launches) == count_patterns "
              f"({rec['count_patterns_launches']} launch) == host scan; "
              f"count_bg_kmers_sharded ({rec['bg_launches']} launches) == "
              f"native count_kmers", flush=True)
        # shard 0's three background tables are the first three launches
        for tag, (ids, inc, n_bins) in (
                ("count_patterns", seen[0]), ("shard_batch", seen[1]),
                ("shard_bg_kmers_0", bg_seen[0]),
                ("shard_bg_kmers_1", bg_seen[1]),
                ("shard_bg_kmers_2", bg_seen[2])):
            k_ms, p_ms, same, err, lib_ms = time_pair(ids, inc, n_bins,
                                                      library=True)
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            b_ms = bound_ms(ids.numel(), n_bins)
            rec[tag] = dict(n=ids.numel(), n_bins=n_bins, ms=k_ms,
                            plain_ms=p_ms, library_ms=lib_ms, bound_ms=b_ms)
            assert same, f"kernel != plain on the {tag} input"
            print(f"  {tag} input n_bins={n_bins} n={ids.numel()}: kernel "
                  f"{k_ms:.4f} ms ({100 * b_ms / k_ms:.1f}% of the "
                  f"{b_ms:.4f} ms bound), plain {p_ms:.4f} ms, library "
                  f"{lib_ms:.4f} ms", flush=True)

    def cli(argv, out):
        log = io.StringIO()
        wall, timing = run_cli(argv + ["--device", "cuda", "--timing", "-o",
                                       out], log)
        return wall, timing, read_bytes(out), log.getvalue()

    with phase("mesh on the card: the CLI with --devices"):
        runs, walls = {}, {"mesh": [], "single": []}
        for label in ("mesh", "single", "single", "mesh"):
            main_path = label == "mesh" and "cli_mesh_launches" not in rec
            if main_path:
                zero_launches()  # the mesh main-path run starts here
            wall, timing, meme, log = cli(
                [large_fasta, "-w", "10", "--engine", "tpu"]
                + (["--devices", "1"] if label == "mesh" else []),
                os.path.join(tmp, f"cli_{label}.meme"))
            if main_path:
                rec["cli_mesh_launches"] = H.LAUNCHES
                rec["cli_mesh_tier_launches"] = dict(H.TIER_LAUNCHES)
            assert engine.LAST_ENGINE_USED == "gpu"
            assert runs.setdefault(label, (meme, log)) == (meme, log)
            walls[label].append(wall)
            print(f"  51.2 Mbases w10 --engine tpu {label:>6}: wall "
                  f"{wall:.3f} s; --timing: " + ", ".join(
                      f"{k} {v:.1f} ms" for k, v in timing.items()),
                  flush=True)
        print(f"  --devices 1 main-path histogram launches: "
              f"{rec['cli_mesh_launches']} {rec['cli_mesh_tier_launches']}; "
              f"walls mesh {walls['mesh']}, single {walls['single']}",
              flush=True)
        assert all(v > 0 for v in rec["cli_mesh_tier_launches"].values()), \
            "a kernel of the mesh main path was launched no time"
        assert runs["mesh"] == runs["single"], \
            "--devices 1: MEME or stdout differs from the single-device run"
        mafk = os.path.join(GOLDEN, "MafK.fasta")
        with count_on("device"):
            zero_launches()
            _, _, mesh_meme, mesh_log = cli(
                [mafk, "-w", "8", "--engine", "exact", "--devices", "1"],
                os.path.join(tmp, "exact_mesh.meme"))
            rec["cli_exact_mesh_launches"] = H.LAUNCHES
            _, _, one_meme, one_log = cli(
                [mafk, "-w", "8", "--engine", "exact"],
                os.path.join(tmp, "exact_one.meme"))
        assert engine.LAST_ENGINE_USED == "exact"
        # the batch count and the three background tables
        assert rec["cli_exact_mesh_launches"] == 4, rec
        assert (mesh_meme, mesh_log) == (one_meme, one_log)
        assert mesh_meme == read_bytes(os.path.join(GOLDEN, "mafk_w8.meme"))
        print(f"  MafK w8 --engine exact --devices 1 (count on the card, "
              f"{rec['cli_exact_mesh_launches']} launches): identical to the "
              f"run without --devices and to the golden file", flush=True)
        from peng_motif_tpu_torch.cli import main as cli_main

        n = torch.cuda.device_count() + 1
        err = io.StringIO()
        refused = os.path.join(tmp, "refused.meme")
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(err):
            rc = cli_main([mafk, "-w", "8", "--devices", str(n), "-o",
                           refused])
        assert rc != 0 and not os.path.exists(refused)
        assert f"requested {n} devices, only {n - 1} available" \
            in err.getvalue(), err.getvalue()
        print(f"  --devices {n} on this machine: exit {rc}, "
              f"{err.getvalue().strip()!r}", flush=True)
        with contextlib.redirect_stdout(io.StringIO()):
            dryrun_multichip(1, "cuda")
        print("  dryrun_multichip(1, cuda): mesh run byte-equal to the "
              "single-device run", flush=True)
    return rec


RANK_REPORT = re.compile(
    r"rank (\d+) of (\d+) counted chunk rows \[(\d+), (\d+)\) on (\d+) x "
    r"(\w+), histogram launches (\d+) \(shared (\d+), l2 (\d+)\), "
    r"backend (\w+)")


def rank_reports(errs):
    """Each rank's own account of its count, from its stderr."""
    out = []
    for pid, err in enumerate(errs):
        m = RANK_REPORT.search(err)
        assert m, f"process {pid} did not report its count:\n{err[-3000:]}"
        rank, world, lo, hi, n_dev, kind, n, shared, l2 = (
            int(g) if g.isdigit() else g for g in m.groups()[:9])
        assert rank == pid and world == len(errs), (rank, world, len(errs))
        out.append(dict(rank=rank, rows=[lo, hi], devices=n_dev,
                        device=kind, launches=n,
                        tier_launches={"shared": shared, "l2": l2},
                        backend=m.group(10)))
    return out


def seeing(cards):
    """The environment of a child process that sees only ``cards``, a
    comma-separated list of this process's card indices: its
    ``CUDA_VISIBLE_DEVICES``, in this process's own terms where that is
    set already."""
    parent = os.environ.get("CUDA_VISIBLE_DEVICES")
    if parent:
        names = parent.split(",")
        cards = ",".join(names[int(c)] for c in cards.split(","))
    return dict(os.environ, CUDA_VISIBLE_DEVICES=cards)


def process_job(tmp, fasta, w, stem, cards, devices=None):
    """One multi-process job of the CLI (device engine), process ``p``
    seeing the cards ``cards[p]`` (CUDA_VISIBLE_DEVICES) and, with
    ``devices``, counting over a local mesh of that many.  Returns (wall
    from the first start to the last exit, process 0's MEME bytes, every
    process's stderr, process 0's JSON bytes and stdout); a worker that
    prints to stdout fails it."""
    out0 = os.path.join(tmp, f"{stem}_p0.meme")
    json0 = os.path.join(tmp, f"{stem}_p0.json")
    port = free_port()
    n = len(cards)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "peng_motif_tpu_torch", fasta, "-w", w,
         "--device", "cuda", "--engine", "tpu", "--timing",
         "--num-processes", str(n), "--process-id", str(pid),
         "--coordinator", f"localhost:{port}"]
        + (["--devices", str(devices)] if devices else [])
        + (["-o", out0, "-j", json0] if pid == 0 else []),
        cwd=REPO, env=seeing(cards[pid]), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for pid in range(n)]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            results.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    for pid, (rc, out, err) in enumerate(results):
        assert rc == 0, f"process {pid} exited {rc}:\n{err[-3000:]}"
        assert pid == 0 or out == "", f"worker {pid} printed to stdout"
    return (wall, read_bytes(out0), [r[2] for r in results],
            read_bytes(json0), results[0][1])


def timing_of(err):
    return ", ".join(ln[len("[TIMING] "):] for ln in err.splitlines()
                     if ln.startswith("[TIMING] "))


def run_process_phase(tmp, large_fasta, dev, scale_rec):
    """Phase 9 (see the module docstring): two processes on one card,
    then NCCL at world size 1 against ``scale_rec``, the recorded
    single-device count of the 51.2-Mbase corpus."""
    import numpy as np

    from peng_motif_tpu_torch.bench_histogram import bound_ms
    from peng_motif_tpu_torch.io.fasta import load_sequence_set
    from peng_motif_tpu_torch.native import pack_codes_fused_native
    from peng_motif_tpu_torch.ops import histogram as H
    from peng_motif_tpu_torch.ops import stream_count
    from peng_motif_tpu_torch.parallel import multihost, sharded

    def single(fasta, w, stem):
        out = os.path.join(tmp, f"{stem}_single.meme")
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "peng_motif_tpu_torch", fasta, "-w", w,
             "--device", "cuda", "--engine", "tpu", "--timing", "-o", out],
            cwd=REPO, env=seeing("0"), capture_output=True, text=True,
            timeout=300)
        assert p.returncode == 0, p.stderr[-3000:]
        return time.perf_counter() - t0, read_bytes(out), p.stderr

    ranks = {}
    with phase("two processes, one card"):
        for fasta, w, stem in (
                (os.path.join(GOLDEN, "MafK.fasta"), "10", "mafk_w10"),
                (large_fasta, "10", "large_w10")):
            # both processes see card 0 alone, whatever the machine has:
            # two ranks sharing one card
            wall2, meme2, errs, _, _ = process_job(tmp, fasta, w, stem,
                                                   ["0", "0"])
            wall1, meme1, err1 = single(fasta, w, stem)
            ranks[stem] = reps = rank_reports(errs)
            print(f"  {stem}: 2-process job wall {wall2:.3f} s (process "
                  f"start to exit; --timing of process 0: "
                  f"{timing_of(errs[0])}), 1-process job wall {wall1:.3f} s "
                  f"({timing_of(err1)}); MEME identical {meme2 == meme1}",
                  flush=True)
            for r in reps:
                print(f"    rank {r['rank']}: chunk rows {r['rows']} on "
                      f"{r['devices']} x {r['device']}, histogram launches "
                      f"{r['launches']} {r['tier_launches']}, backend "
                      f"{r['backend']}", flush=True)
                # the 4**10 table alone (no fused background): the L2 tier
                assert r["device"] == "cuda" and r["devices"] == 1, r
                assert r["launches"] > 0, r
                assert r["tier_launches"] == {"shared": 0,
                                              "l2": r["launches"]}, r
                # the two ranks share the card, and NCCL refuses that
                assert r["backend"] == "gloo", r
            assert reps[0]["rows"][0] == 0
            assert reps[0]["rows"][1] == reps[1]["rows"][0]
            assert meme2 == meme1, f"{stem}: 2-process MEME != 1-process MEME"

    with phase("one rank's block of the 51.2-Mbase corpus, in this process"):
        sset = load_sequence_set(large_fasta)
        stream, lay = stream_count.build_stream(
            sset.sequences, 10, flat_codes=sset._flat_codes)
        per, lay = sharded.shard_layout(lay, 2)
        want = ranks["large_w10"][1]
        assert want["rows"] == [per, 2 * per], (want, per)
        rows = pack_codes_fused_native(
            stream_count.chunk_rows(stream, lay)[per : 2 * per])
        del stream
        seen = []

        def hist(real, ids, inc, n_bins, out):
            seen.append((ids.clone(), inc.clone(), n_bins))
            return real(ids, inc, n_bins, out=out)

        before = H.LAUNCHES
        with stream_histogram(hist):
            sharded.stream_counts_over_mesh(rows, None, lay.row, lay.ctx, 10,
                                            True, -1, (dev,), per, base=per)
        assert H.LAUNCHES - before == len(seen) == want["launches"], \
            (H.LAUNCHES - before, len(seen), want)
        ids, inc, n_bins = seen[0]
        k_ms, p_ms, same, err, lib_ms = time_pair(ids, inc, n_bins,
                                                  library=True)
        b_ms = bound_ms(ids.numel(), n_bins)
        print(f"  rank 1's block, rows [{per}, {2 * per}): {len(seen)} "
              f"launch(es) as the rank reported; input n_bins={n_bins} "
              f"n={ids.numel()} counted={int(inc.sum())}: kernel {k_ms:.4f} "
              f"ms ({100 * b_ms / k_ms:.1f}% of the {b_ms:.4f} ms bound), "
              f"plain {p_ms:.4f} ms, library {lib_ms:.4f} ms, bit-identical "
              f"{same}", flush=True)
        assert same and err == 0, "kernel != plain on a rank's block"
        block = dict(n=ids.numel(), n_bins=n_bins, ms=k_ms, plain_ms=p_ms,
                     library_ms=lib_ms, bound_ms=b_ms, max_abs_err=err)
        del seen, ids, inc, rows

    with phase("NCCL at world size 1"):
        before = H.LAUNCHES
        t0 = time.perf_counter()
        # one card, however many the machine has: a world of one rank
        # that owns its card
        ctx = multihost.init_multihost(f"localhost:{free_port()}", 1, 0,
                                       timeout_s=120, device=dev,
                                       mesh=(dev,))
        t1 = time.perf_counter()
        try:
            assert multihost.LAST_BACKEND == ctx.backend == "nccl", ctx
            assert ctx.device.type == "cuda" and ctx.shards == (1,)
            bg = multihost.multihost_bg_counts(ctx, sset.sequences, 2)
            t2 = time.perf_counter()
            counts, ltot = multihost.multihost_stream_counts(
                ctx, sset.sequences, 10, True, flat_codes=sset._flat_codes)
            t3 = time.perf_counter()
        finally:
            multihost.shutdown_multihost()
        launches = H.LAUNCHES - before
        print(f"  LAST_BACKEND {multihost.LAST_BACKEND}: init {t1 - t0:.3f} "
              f"s, background counts {t2 - t1:.3f} s, stream count "
              f"{t3 - t2:.3f} s, histogram launches {launches}, ltot {ltot}",
              flush=True)
        assert launches > 0, "the multi-process count launched no kernel"
        assert np.array_equal(counts, scale_rec.counts), \
            "world-of-one count table != single-device count table"
        assert ltot == scale_rec.ltot
        assert all(np.array_equal(a, b) for a, b in zip(bg, scale_rec.bg))
        print("  count table, ltot and background counts equal to the "
              "single-device run's", flush=True)
    return {"two_processes": ranks, "rank_block": block,
            "backend_world_of_one": multihost.LAST_BACKEND,
            "nccl_launches": launches}


def zero_launches():
    from peng_motif_tpu_torch.ops import histogram as H

    H.LAUNCHES = 0
    H.TIER_LAUNCHES.update(shared=0, l2=0)
    H.DEVICE_LAUNCHES.clear()


def write_wide_corpus(path):
    """The 20-Mbase corpus of the reference's hardware test
    (tests_hw/test_hw_parity.py::test_large_corpus_wide_path): 10,000 x
    2,000 bp, seed 13, ~25% of the sequences carrying TGACTCAC."""
    import numpy as np

    rng = np.random.default_rng(13)
    let = np.frombuffer(b"ACGT", dtype=np.uint8)
    n_seq, L = 10_000, 2_000
    rows = let[rng.integers(0, 4, size=(n_seq, L))]
    mot = np.frombuffer(b"TGACTCAC", dtype=np.uint8)
    pos = rng.integers(0, L - 8, size=n_seq)
    for i in np.flatnonzero(rng.random(n_seq) < 0.25):
        rows[i, pos[i] : pos[i] + 8] = mot
    with open(path, "wb") as f:
        for i in range(n_seq):
            f.write(b">s%d\n" % i)
            f.write(rows[i].tobytes())
            f.write(b"\n")
    return n_seq * L


def run_parity_phase(tmp):
    """Phase 10 (see the module docstring)."""
    from peng_motif_tpu_torch import engine
    from peng_motif_tpu_torch.ops import histogram as H

    with phase("parity: the reference's hardware cases (--device cuda)"):
        cases = [
            ("mafk100_w8_plus", ["MafK_100seqs.fasta", "-w", "8", "--strand",
                                 "PLUS"]),
            ("mafk100_w8_logpval", ["MafK_100seqs.fasta", "-w", "8",
                                    "--optimization_score", "LOGPVAL"]),
            ("mafk100_w8_enrich", ["MafK_100seqs.fasta", "-w", "8",
                                   "--optimization_score", "ENRICHMENT"]),
            ("mafk100_w12", ["MafK_100seqs.fasta", "-w", "12"]),
            ("mafk_w8_rich", ["MafK.fasta", "-w", "8", "-t", "5",
                              "--minimum-processed-patterns", "25"])]
        for stem, args in cases:
            out = os.path.join(tmp, f"parity_{stem}.meme")
            before = H.LAUNCHES
            wall, _ = run_cli([os.path.join(GOLDEN, args[0])] + args[1:]
                              + ["--device", "cuda", "--engine", "tpu", "-o",
                                 out])
            got = read_bytes(out).decode()
            want = read_bytes(os.path.join(GOLDEN, f"{stem}.meme")).decode()
            tol = 2e-5 if stem == "mafk_w8_rich" else TOL_ABS
            ok = within_tolerance(got, want, tol_abs=tol)
            _, d_cell, d_hdr = compare_outputs(got, want)
            print(f"  {stem}: wall {wall:.3f} s, within {tol:g} + "
                  f"{TOL_REL:g} relative of golden {ok} (max PWM-cell "
                  f"difference {d_cell:.3g}, header {d_hdr:.3g} relative), "
                  f"byte-identical {got == want}, histogram launches "
                  f"{H.LAUNCHES - before}", flush=True)
            assert ok, f"{stem}: MEME output outside the tolerance"
            assert engine.LAST_ENGINE_USED == "gpu"
            assert engine.LAST_CLIMB_ENGINE == "device"
            assert engine.LAST_PWM_ENGINE == "device"
            assert H.LAUNCHES > before, f"{stem}: no kernel launch"

    with phase("parity: 20 Mbases -w 8, device engine against exact engine"):
        fasta = os.path.join(tmp, "large20.fasta")
        n = write_wide_corpus(fasta)
        runs = {}
        for eng in ("tpu", "exact"):
            out = os.path.join(tmp, f"large20_{eng}.meme")
            log = io.StringIO()
            before = H.LAUNCHES
            wall, _ = run_cli([fasta, "-w", "8", "--device", "cuda",
                               "--engine", eng, "-o", out], log)
            runs[eng] = (read_bytes(out).decode(), log.getvalue())
            print(f"  {n} bases --engine {eng}: wall {wall:.3f} s, engine "
                  f"{engine.LAST_ENGINE_USED}, histogram launches "
                  f"{H.LAUNCHES - before}", flush=True)
            # no fallback: the device engine ran to its end
            assert engine.LAST_ENGINE_USED == (
                "gpu" if eng == "tpu" else "exact")
        for what, a, b in (("MEME", runs["tpu"][0], runs["exact"][0]),
                           ("stdout", runs["tpu"][1], runs["exact"][1])):
            _, d_cell, d_hdr = compare_outputs(a, b)
            ok = within_tolerance(a, b, tol_abs=1e-4, tol_rel=1e-5)
            print(f"  {what}: every non-float token equal and floats within "
                  f"1e-4 + 1e-5 relative {ok} (max absolute difference "
                  f"{d_cell:.3g}; header lines {d_hdr:.3g} relative; "
                  f"byte-identical {a == b})", flush=True)
            assert ok, f"20 Mbases: {what} of the two engines differs"


def run_entry_phase(dev):
    """Phase 11 (see the module docstring).  Returns the record of
    ``entry()``'s launch for the kernels line."""
    import numpy as np
    import torch

    from peng_motif_tpu_torch import graft_entry
    from peng_motif_tpu_torch.bench_histogram import bound_ms
    from peng_motif_tpu_torch.io.fasta import load_sequence_set
    from peng_motif_tpu_torch.models.background import BackgroundModel
    from peng_motif_tpu_torch.ops import (bgprobs, counting, em, encoding,
                                          iupac_sum, stats)
    from peng_motif_tpu_torch.ops import flat_tables as ft
    from peng_motif_tpu_torch.ops import histogram as H

    rec = {}
    with phase("entry(): one forward step on the card"):
        fn, args = graft_entry.entry()
        seen = []
        real_hist = counting.histogram

        def rec_hist(ids, inc, n_bins, out=None):
            seen.append((ids.clone(), inc.clone(), n_bins))
            return real_hist(ids, inc, n_bins, out=out)

        counting.histogram = rec_hist
        try:
            zero_launches()
            t0 = time.perf_counter()
            z = fn(*args)                   # no device named: the card
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
        finally:
            counting.histogram = real_hist
        rec["entry_launches"] = H.LAUNCHES
        rec["entry_tier_launches"] = dict(H.TIER_LAUNCHES)
        assert z.device.type == "cuda" and z.shape == (4 ** 6,), z
        assert H.LAUNCHES == len(seen) == 1, (H.LAUNCHES, len(seen))
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        want = fn(*args, device="cpu")
        assert want.device.type == "cpu"
        assert bool(torch.isfinite(z).all())
        diff = float((z.cpu() - want).abs().max())
        # z = (n - mu) / sqrt(mu) from identical counts and a bit-equal
        # background table: 1e-6 relative + 1e-6 absolute
        torch.testing.assert_close(z.cpu(), want, rtol=1e-6, atol=1e-6)
        print(f"  entry(): output {tuple(z.shape)} on {z.device}, "
              f"{rec['entry_launches']} histogram launch "
              f"{rec['entry_tier_launches']}, z-scores card against cpu "
              f"max abs difference {diff:.3g} "
              f"(bit-identical {torch.equal(z.cpu(), want)}); wall first call "
              f"{first * 1e3:.3f} ms, median of 5 more "
              f"{median(walls) * 1e3:.3f} ms", flush=True)
        ids, inc, n_bins = seen[0]
        k_ms, p_ms, same, err, lib_ms = time_pair(ids, inc, n_bins,
                                                  library=True)
        b_ms = bound_ms(ids.numel(), n_bins)
        print(f"  entry() input n_bins={n_bins} n={ids.numel()} "
              f"counted={int(inc.sum())}: kernel {k_ms:.4f} ms "
              f"({100 * b_ms / k_ms:.1f}% of the {b_ms:.4f} ms bound), plain "
              f"{p_ms:.4f} ms, library {lib_ms:.4f} ms, bit-identical {same}",
              flush=True)
        assert same and err == 0, "kernel != plain on entry()'s input"
        rec["entry"] = dict(n=ids.numel(), n_bins=n_bins, ms=k_ms,
                            plain_ms=p_ms, library_ms=lib_ms, bound_ms=b_ms,
                            max_abs_err=err)

    with phase("rank-W tensor ops at W = 8 on the MafK count, card vs cpu"):
        W = 8
        ss = load_sequence_set(os.path.join(GOLDEN, "MafK.fasta"))
        counts_d, ltot = counting.count_patterns(
            torch.from_numpy(ss.padded()).to(dev), W, True)
        counts_np = counts_d.cpu().numpy()
        v_np = BackgroundModel(ss.sequences, order=2).v
        rng = np.random.default_rng(8)
        masks_np = rng.integers(0, 2, size=(64, W, 4)).astype(np.int32)
        pwms_np = rng.dirichlet(np.ones(4), size=(6, W)).astype(np.float32)
        outs, walls = {}, {}
        for d in (dev, torch.device("cpu")):
            def sync():
                if d.type == "cuda":
                    torch.cuda.synchronize()
            t = {}
            counts = torch.from_numpy(counts_np).to(d)
            v = [torch.from_numpy(np.asarray(x, np.float32)).to(d)
                 for x in v_np]
            masks = torch.from_numpy(masks_np).to(d)
            sync()
            t0 = time.perf_counter()
            bg = bgprobs.bg_prob_table(v, W, 2)
            agg = bgprobs.aggregate_double_strand(bg)
            sync()
            t["bg_prob_table"] = time.perf_counter() - t0
            flat = ft.aggregate_double_strand_flat(
                ft.bg_prob_flat(v, W, 2), W)
            assert torch.equal(encoding.to_flat(agg), flat), \
                "rank-W background table != the flat one"
            canon = encoding.canonical_mask(W, d)
            expected = stats.expected_counts(agg, ltot)
            floats = torch.stack([expected, agg]) * canon
            counts_t = encoding.to_tensor(counts, W)
            sync()
            t0 = time.perf_counter()
            c_sum, f_sum = iupac_sum.aggregate_batch(counts_t * canon,
                                                     floats, masks, True)
            sync()
            t["aggregate_batch"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            pwm, iters = em.em_optimize(
                torch.from_numpy(pwms_np).to(d), counts_t.to(torch.float32),
                agg, 1e4, 0.08, 20, W)
            sync()
            t["em_optimize"] = time.perf_counter() - t0
            outs[d.type] = [x.cpu() for x in (agg, c_sum, f_sum, pwm, iters)]
            walls[d.type] = t
        a, b = outs["cuda"], outs["cpu"]
        assert torch.equal(a[0], b[0]), "bg_prob_table: card != cpu"
        assert torch.equal(a[1], b[1]) and int(b[1].max()) > 0, \
            "aggregate_batch: counts differ"
        f_rel = float(((a[2] - b[2]).abs() / b[2].abs().clamp_min(1e-30)).max())
        # three-term sums of 4**8 f32 products, contracted axis by axis
        torch.testing.assert_close(a[2], b[2], rtol=1e-5, atol=0)
        assert torch.equal(a[4], b[4]), "em_optimize: iterations differ"
        d_pwm = float((a[3] - b[3]).abs().max())
        torch.testing.assert_close(a[3], b[3], rtol=0, atol=5e-6)
        print(f"  MafK -w 8 ({int(counts_np.sum())} counts, ltot {ltot}): "
              f"bg_prob_table + aggregate_double_strand bit-identical card "
              f"vs cpu and to flat_tables; aggregate_batch (64 masks) counts "
              f"identical, floats within 1e-5 relative (max {f_rel:.3g}); "
              f"em_optimize (6 motifs) iterations {a[4].tolist()} identical, "
              f"PWMs within 5e-6 (max {d_pwm:.3g})", flush=True)
        for k, t in walls.items():
            print(f"    on {k}: {fmt_walls(t)}", flush=True)
    return rec


def run_hybrid_phase(tmp, large_fasta, dev, n_bases):
    """Phase 12 (see the module docstring).  Returns the ``hybrid``
    object of the kernels line."""
    import numpy as np
    import torch

    from peng_motif_tpu_torch import engine
    from peng_motif_tpu_torch.io.fasta import load_sequence_set
    from peng_motif_tpu_torch.models.background import BackgroundModel
    from peng_motif_tpu_torch.ops import histogram as H

    rec = {"ends": {}, "rule": {}, "launches": {}, "walls": {}}
    both, bg_order = True, 2
    sset = load_sequence_set(large_fasta)
    assert sset.total_bases == n_bases
    cores = os.cpu_count()
    names = {None: "the rule", False: "card", True: "host"}

    def count_phase_wall(ss, W, on_host):
        """engine._count_phase on ``ss`` at a forced end."""
        peng = types.SimpleNamespace(
            sequence_set=ss,
            bg_model=BackgroundModel(ss.sequences, order=bg_order,
                                     interpolate=True, defer=True))
        with count_end(on_host):
            t0 = time.perf_counter()
            engine._count_phase(peng, W, both, dev)
            return time.perf_counter() - t0

    mafk = os.path.join(GOLDEN, "MafK.fasta")
    mafk100 = os.path.join(GOLDEN, "MafK_100seqs.fasta")
    with phase("hybrid: the count phase on the card and on the host, by "
               "corpus size"):
        # the walls behind the rule's crossover (ops/hybrid.py): the whole
        # count phase at either end over prefixes of the corpus, in turns,
        # and the two ends' rates and fixed costs fitted to them
        ladder = {"51.2 Mbases": sset}
        for n_seq in (8, 500, 5000):
            path = os.path.join(tmp, f"prefix{n_seq}.fasta")
            with open(large_fasta, "rb") as f, open(path, "wb") as g:
                g.writelines(f.readline() for _ in range(2 * n_seq))
            ss = load_sequence_set(path)
            assert ss.n == n_seq
            ladder["8 seqs" if n_seq == 8 else
                   f"{ss.total_bases / 1e6:.1f} Mbases"] = ss
        ladder["MafK_100seqs"] = load_sequence_set(mafk100)
        ladder["MafK"] = load_sequence_set(mafk)
        ladder = dict(sorted(ladder.items(),
                             key=lambda kv: kv[1].total_bases))
        for W in (8, 10, 12):
            ends = {}
            for name, ss in ladder.items():
                count_phase_wall(ss, W, False)            # warm-up
                walls = {False: [], True: []}
                for on_host in (False, True, True, False, False, True):
                    walls[on_host].append(count_phase_wall(ss, W, on_host))
                ends[name] = dict(bases=ss.total_bases,
                                  device_s=median(walls[False]),
                                  host_s=median(walls[True]))
            small, large = ends["8 seqs"], ends["51.2 Mbases"]
            # seconds per base at either end, from the small corpus to
            # the large one; the card's can drown in the spread of its
            # fixed cost (then 0: no rate resolved)
            lat = small["device_s"] - small["host_s"]
            span = large["bases"] - small["bases"]
            per_d = max(large["device_s"] - small["device_s"], 0.0) / span
            per_h = max(large["host_s"] - small["host_s"], 1e-9) / span
            for name, e in ends.items():
                e["rule_host"] = RULE(dev, e["bases"], W)
                e["fitted_host"] = bool(
                    e["bases"] * per_h < e["bases"] * per_d + lat)
                e["faster_host"] = bool(e["host_s"] < e["device_s"])
                print(f"  w{W} {name} ({e['bases']} bases): count phase "
                      f"on the card {e['device_s']:.4f} s, on the host "
                      f"{e['host_s']:.4f} s; the rule counts on the "
                      f"{'host' if e['rule_host'] else 'card'}, this run's "
                      f"fit on the {'host' if e['fitted_host'] else 'card'}"
                      f", the faster end the "
                      f"{'host' if e['faster_host'] else 'card'}"
                      + ("" if e["rule_host"] == e["faster_host"] else
                         f" (the rule costs "
                         f"{abs(e['device_s'] - e['host_s']):.4f} s)"),
                      flush=True)
            cross = (lat / (per_h - per_d) if lat > 0 and per_h > per_d
                     else None)
            print(f"  w{W} fit: device count "
                  + (f"{1e-6 / per_d:.1f} Mbases/s" if per_d else
                     "at no resolved rate (its walls' spread exceeds B/d)")
                  + f", host count {1e-6 / per_h:.1f} Mbases/s, fixed cost "
                  f"of a device count less the host count's "
                  f"{lat * 1e3:.1f} ms; "
                  + ("the card at every size" if cross is None else
                     f"the host below {cross / 1e6:.1f} Mbases")
                  + f" ({cores} host cores)", flush=True)
            rec["ends"][str(W)] = dict(
                corpora=ends, device_s_per_base=per_d, host_s_per_base=per_h,
                latency_s=lat, crossover_bases=cross)

    def cli(fasta, w, on_host, out):
        """One job at a forced end (None: the rule's)."""
        r = Recorder()
        log = io.StringIO()
        with count_end(on_host), r.active():
            zero_launches()
            wall, _ = run_cli([fasta, "-w", w, "--device", "cuda", "--engine",
                               "tpu", "-o", out], log)
            r.launches = H.LAUNCHES
            r.tier_launches = dict(H.TIER_LAUNCHES)
        assert engine.LAST_ENGINE_USED == "gpu"
        r.frac, r.wall = engine.LAST_HYBRID_FRAC, wall
        r.meme, r.log = read_bytes(out), log.getvalue()
        return r

    for stem, fasta, w, turns in (("large_w10", large_fasta, "10", 4),
                                  ("mafk_w10", mafk, "10", 4),
                                  ("mafk100_w12", mafk100, "12", 2)):
        with phase(f"hybrid: {stem} through the CLI, card, host and the "
                   f"rule"):
            rule = RULE(dev, load_sequence_set(fasta).total_bases, int(w))
            runs = {}
            for on_host in (False, True, None):
                r = cli(fasta, w, on_host,
                        os.path.join(tmp, f"hy_{stem}_{on_host}.meme"))
                runs[on_host] = r
                want = rule if on_host is None else on_host
                assert r.frac == (0.0 if want else 1.0), (stem, on_host)
                print(f"  {stem} {names[on_host]}: LAST_HYBRID_FRAC "
                      f"{r.frac:.1f}, histogram launches {r.launches} "
                      f"{r.tier_launches}, wall {r.wall:.3f} s, count phase "
                      f"{r.count_s:.3f} s, ltot {r.ltot}", flush=True)
                assert (r.launches == 0) == want, (stem, on_host)
                # the kernel on the run's own ids
                for n_bins, (ids, inc) in sorted(r.inputs.items()):
                    got = H.histogram(ids, inc, n_bins)
                    plain = H.histogram_plain(ids, inc, n_bins)
                    torch.cuda.synchronize()
                    assert torch.equal(got, plain), (stem, on_host, n_bins)
                r.inputs = {}
            rec["launches"][stem] = {names[k]: r.launches
                                     for k, r in runs.items()}
            rec["rule"][stem] = "host" if rule else "card"
            for on_host, r in runs.items():
                assert same_record(r, runs[False]), \
                    f"{stem}: {names[on_host]} changed the count's results"
                assert (r.meme, r.log) == (runs[False].meme,
                                           runs[False].log), \
                    f"{stem}: {names[on_host]} changed the output"
            print(f"  {stem}: count table, ltot, background counts, MEME "
                  f"bytes and stdout identical across the three; the kernel "
                  f"bit-identical to the plain version on each run's ids",
                  flush=True)
            # the rule (a) against the card (b): a, b, b, a, ...
            walls = {None: [], False: []}
            for on_host in (None, False, False, None) * turns:
                r = cli(fasta, w, on_host, os.path.join(tmp, "hy_wall.meme"))
                walls[on_host].append((r.wall, r.count_s))
            for on_host, ws in walls.items():
                job, cnt = [w[0] for w in ws], [w[1] for w in ws]
                print(f"  {stem} {names[on_host]}: job wall median "
                      f"{median(job):.4f} s (range {min(job):.4f}-"
                      f"{max(job):.4f}), count phase median {median(cnt):.4f}"
                      f" s (range {min(cnt):.4f}-{max(cnt):.4f}), {len(ws)} "
                      f"runs", flush=True)
            rec["walls"][stem] = {
                names[k]: dict(job_median_s=median([w[0] for w in ws]),
                               count_median_s=median([w[1] for w in ws]),
                               runs=len(ws))
                for k, ws in walls.items()}

    # a default run on each side of the rule's crossover
    assert rec["rule"]["large_w10"] == "card", rec["rule"]
    assert rec["rule"]["mafk100_w12"] == "host", rec["rule"]
    assert rec["launches"]["large_w10"]["the rule"] == 14
    assert rec["launches"]["mafk100_w12"]["the rule"] == 0

    with phase("hybrid: 51.2 Mbases -w 12, the count phase alone"):
        recs = {}
        for on_host in (False, True, None):
            r = Recorder()
            peng = types.SimpleNamespace(
                sequence_set=sset,
                bg_model=BackgroundModel(sset.sequences, order=bg_order,
                                         interpolate=True, defer=True))
            with count_end(on_host), r.active():
                zero_launches()
                out = engine._count_phase(peng, 12, both, dev)
                r.launches = H.LAUNCHES
            # the resident table, completed as stats_program completes it
            state = engine.resident_state(out[2], out[1], out[3], out[4], [],
                                          dev)
            resident = state.counts.clone()
            resident.index_add_(0, state.fix_ids, state.fix_dv)
            assert np.array_equal(resident.cpu().numpy(), r.counts), \
                f"w12 {names[on_host]}: the resident table != counts_host"
            r.inputs = {}
            recs[on_host] = r
            print(f"  w12 {names[on_host]}: LAST_HYBRID_FRAC "
                  f"{engine.LAST_HYBRID_FRAC:.1f}, count phase "
                  f"{r.count_s:.3f} s, ltot {r.ltot}, histogram launches "
                  f"{r.launches}", flush=True)
            assert same_record(r, recs[False]), \
                f"w12: {names[on_host]} differs"
        rec["launches"]["large_w12_count"] = {names[k]: r.launches
                                              for k, r in recs.items()}
        print("  w12: count table, ltot and background counts identical "
              "across the three; the resident table with its fix-up equals "
              "the host table", flush=True)
        # the rule's end, the card and the host in turns: the count phase
        # alone, then whole jobs
        walls = {k: [] for k in names}
        for on_host in (None, False, True, True, False, None) * 2 + (
                None, False, True):
            walls[on_host].append(count_phase_wall(sset, 12, on_host))
        jobs, meme = {False: [], True: []}, None
        for on_host in (False, True, True, False):
            r = cli(large_fasta, "12", on_host,
                    os.path.join(tmp, "hy_w12.meme"))
            jobs[on_host].append(r.wall)
            meme = meme or r.meme
            assert r.meme == meme, "w12: the host count's MEME differs"
        rule = "host" if RULE(dev, n_bases, 12) else "card"
        for on_host, name in names.items():
            ws = walls[on_host]
            print(f"  w12 {name}{f' ({rule})' if on_host is None else ''}: "
                  f"count phase median {median(ws):.4f} s (range "
                  f"{min(ws):.4f}-{max(ws):.4f}), {len(ws)} runs"
                  + (f"; job walls {jobs[on_host]}" if on_host in jobs
                     else ""), flush=True)
        rec["walls"]["large_w12"] = {
            names[k]: dict(count_median_s=median(walls[k]),
                           runs=len(walls[k]), job_walls_s=jobs.get(k))
            for k in names}
        rec["rule"]["large_w12"] = rule
    return rec


def json_close(a, b, tol_abs=TOL_ABS, tol_rel=TOL_REL) -> bool:
    """Two parsed JSON documents: the same structure, strings and
    integers equal, floats within tol_abs + tol_rel * |b| (nan == nan)."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(
            json_close(a[k], b[k], tol_abs, tol_rel) for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(
            json_close(x, y, tol_abs, tol_rel) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float):
        return (a == b or (a != a and b != b)
                or abs(a - b) <= tol_abs + tol_rel * abs(b))
    return type(a) is type(b) and a == b


def run_shoot_phase(tmp):
    """Phase 13 (see the module docstring)."""
    with phase("shoot: python -m peng_motif_tpu_torch.shoot"):
        fasta = os.path.join(GOLDEN, "MafK_100seqs.fasta")
        procs, t0 = {}, time.perf_counter()
        for where, extra in (("cuda", ["--device", "cuda"]),
                             ("cpu", ["--device", "cpu", "--engine", "tpu"])):
            procs[where] = subprocess.Popen(
                [sys.executable, "-m", "peng_motif_tpu_torch.shoot", fasta,
                 "-w", "8", "--no-scoring", "--silent", "-o",
                 os.path.join(tmp, f"shoot_{where}.meme"), "-j",
                 os.path.join(tmp, f"shoot_{where}.json")] + extra,
                cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)
        try:
            for where, p in procs.items():
                _, err = p.communicate(timeout=300)
                assert p.returncode == 0, \
                    f"shoot on {where} exited {p.returncode}:\n{err[-3000:]}"
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        wall = time.perf_counter() - t0
        memes = {w: read_bytes(os.path.join(tmp, f"shoot_{w}.meme")).decode()
                 for w in procs}
        docs = {}
        for w in procs:
            with open(os.path.join(tmp, f"shoot_{w}.json")) as f:
                docs[w] = json.load(f)
        assert "zoops_score= nan occur= nan" in memes["cuda"]
        assert docs["cuda"]["patterns"], "shoot wrote no pattern"
        ok_meme = within_tolerance(memes["cuda"], memes["cpu"])
        ok_json = json_close(docs["cuda"], docs["cpu"])
        print(f"  MafK_100seqs -w 8 --no-scoring: both exit 0 in {wall:.3f} "
              f"s (side by side), {len(docs['cuda']['patterns'])} patterns; "
              f"--device cuda against --device cpu: MEME within tolerance "
              f"{ok_meme} (byte-identical {memes['cuda'] == memes['cpu']}), "
              f"JSON within tolerance {ok_json}", flush=True)
        assert ok_meme and ok_json, "shoot: card and cpu outputs differ"


class CardWatch:
    """From the end of the count phase to the end of the run, the
    histogram launches and the peak of allocated memory on each of
    ``cards``: the proof that nothing after the count touches them."""

    def __init__(self, cards):
        self.cards = list(cards)

    @contextlib.contextmanager
    def active(self):
        import torch

        from peng_motif_tpu_torch import engine
        from peng_motif_tpu_torch.ops import histogram as H

        real = engine._count_phase
        base = {}

        def count_phase(*a, **k):
            out = real(*a, **k)
            for c in self.cards:
                torch.cuda.synchronize(c)
                torch.cuda.reset_peak_memory_stats(c)
                base[c] = (torch.cuda.memory_allocated(c),
                           H.DEVICE_LAUNCHES.get(c, 0))
            return out

        engine._count_phase = count_phase
        try:
            yield
        finally:
            engine._count_phase = real
        for c in self.cards:
            assert c in base, "the run had no count phase"
            peak = torch.cuda.max_memory_allocated(c)
            assert peak <= base[c][0], \
                f"cuda:{c}: {peak - base[c][0]} B allocated after the count"
            assert H.DEVICE_LAUNCHES.get(c, 0) == base[c][1], \
                f"cuda:{c}: a kernel launched after the count"


def run_cards_phase(tmp, large_fasta, dev):
    """Phase 14 (see the module docstring).  Returns the ``cards`` object
    of the kernels line, or None on a machine with one card."""
    import numpy as np
    import torch

    from peng_motif_tpu_torch import engine
    from peng_motif_tpu_torch.bench_histogram import bound_ms
    from peng_motif_tpu_torch.io.fasta import load_sequence_set
    from peng_motif_tpu_torch.models.background import count_kmers
    from peng_motif_tpu_torch.ops import counting
    from peng_motif_tpu_torch.ops import histogram as H
    from peng_motif_tpu_torch.parallel import multihost, sharded
    from peng_motif_tpu_torch.parallel.dryrun import dryrun_multichip
    from peng_motif_tpu_torch.parallel.mesh import make_data_mesh

    names = ("cards: the kernel on every card, the sharded stream count",
             "cards: the sharded batch and background counts",
             "cards: the CLI with --devices",
             "cards: processes over NCCL, one card or two each",
             "cards: dryrun_multichip")
    n = torch.cuda.device_count()
    if n < 2:
        for name in names:
            print(f"[phase] {name}: not run: {n} card", flush=True)
        return None
    sizes = [2] + ([min(n, 4)] if n > 2 else [])
    big = sizes[-1]
    mafk = os.path.join(GOLDEN, "MafK.fasta")
    mafk100 = os.path.join(GOLDEN, "MafK_100seqs.fasta")
    rec = {"cards": n, "meshes": sizes, "max_abs_err": 0, "per_card": {},
           "stream_launches": {}}

    def every_card(launches, m, each=None):
        """The launches by card of a run over ``m`` cards: each card
        launched (``each`` times, when given)."""
        assert sorted(launches) == list(range(m)), launches
        assert each is None or set(launches.values()) == {each}, launches

    with phase(names[0]):
        inputs = {}     # (card, n_bins): the first input each card counted
        for fasta, W in ((mafk, 6), (mafk, 8), (large_fasta, 10),
                         (large_fasta, 12)):
            ss = load_sequence_set(fasta)
            bg_order = 2 if W >= 8 else -1
            outs = {}
            for m in [1] + (sizes if W == 10 else [big]):
                mesh = (dev,) if m == 1 else make_data_mesh(m, "cuda")

                def hist(real, ids, inc, n_bins, out, keep=m == big):
                    key = (ids.device.index, n_bins)
                    if keep and key not in inputs:
                        inputs[key] = (ids.clone(), inc.clone())
                    return real(ids, inc, n_bins, out=out)

                zero_launches()
                t0 = time.perf_counter()
                with stream_histogram(hist):
                    _stream, lay, out = sharded.stream_count_sharded(
                        ss.sequences, W, True, mesh,
                        flat_codes=ss._flat_codes, bg_order=bg_order,
                        n_undefined=ss.n_undefined)
                for d in set(mesh):
                    torch.cuda.synchronize(d)
                wall = time.perf_counter() - t0
                launches = dict(H.DEVICE_LAUNCHES)
                every_card(launches, m)
                assert all(t.device == mesh[0] for t in out
                           if t is not None), "a result off the first card"
                outs[m] = (lay, [t.cpu() for t in out if t is not None])
                rec["stream_launches"][f"w{W}_mesh{m}"] = launches
                print(f"  w{W} {os.path.basename(fasta)} over {m} card(s): "
                      f"m_pad {lay.m_pad}, launches by card {launches}, "
                      f"count wall {wall:.4f} s", flush=True)
            lay1, want = outs[1]
            for m, (lay, got) in outs.items():
                assert lay.m == lay1.m and len(got) == len(want)
                for name, a, b in zip(("counts", "vals", "ltot", "susp",
                                       "bg"), got, want):
                    if name == "susp":
                        assert not a[lay1.m_pad:].any(), (W, m)
                        a = a[: lay1.m_pad]
                    assert torch.equal(a, b), f"w{W} mesh {m}: {name} differs"
            print(f"  w{W}: count table, canonical slice, ltot, suspicion"
                  + (" and background counts" if bg_order >= 0 else "")
                  + f" over {sorted(outs)} card(s) bit-identical", flush=True)
            del ss, outs
        for (card, n_bins), (ids, inc) in sorted(inputs.items()):
            with torch.cuda.device(card):
                k_ms, p_ms, same, err, lib_ms = time_pair(ids, inc, n_bins,
                                                          library=True)
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            b_ms = bound_ms(ids.numel(), n_bins)
            print(f"  cuda:{card} input n_bins={n_bins} n={ids.numel()} "
                  f"counted={int(inc.sum())}: kernel {k_ms:.4f} ms "
                  f"({100 * b_ms / k_ms:.1f}% of the {b_ms:.4f} ms bound), "
                  f"plain {p_ms:.4f} ms, library {lib_ms:.4f} ms, "
                  f"bit-identical {same}", flush=True)
            assert same, f"kernel != plain on cuda:{card} at {n_bins} bins"
            rec["per_card"].setdefault(str(card), {})[str(n_bins)] = dict(
                n=ids.numel(), ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                bound_ms=b_ms)
        assert len({c for c, _ in inputs}) == big
        del inputs

    with phase(names[1]):
        ss = load_sequence_set(mafk)
        codes = ss.padded()
        b = codes.shape[0]
        host = counting.CountJob(codes, 8, True, "cpu").finish()
        one = sharded.count_device_full_sharded(codes, 8, True, (dev,))
        lengths = np.array([len(s) for s in ss.sequences], dtype=np.int32)
        want_bg = count_kmers(ss.sequences, 2)
        for m in sizes:
            mesh = make_data_mesh(m, "cuda")
            zero_launches()
            got, got_ltot = sharded.count_patterns_sharded(codes, 8, True,
                                                           mesh)
            every_card(dict(H.DEVICE_LAUNCHES), m, each=1)
            assert np.array_equal(got, host[0]) and got_ltot == host[1]
            full = sharded.count_device_full_sharded(codes, 8, True, mesh)
            for name, a, w in zip(("counts", "vals", "ltot", "susp"),
                                  full[:4], one[:4]):
                assert a.device == mesh[0], name
                a = a.cpu()
                if name == "susp":
                    assert not a[b:].any()
                    a = a[:b]
                assert torch.equal(a, w.cpu()), f"mesh {m}: {name} differs"
            zero_launches()
            bg = sharded.count_bg_kmers_sharded(codes, 2, mesh,
                                                lengths=lengths)
            every_card(dict(H.DEVICE_LAUNCHES), m, each=3)
            for g, w in zip(bg, want_bg):
                assert np.array_equal(g, w), f"mesh {m}: background differs"
            print(f"  MafK -w 8 over {m} cards: count_patterns_sharded == "
                  f"host scan (one launch a card), count_device_full_sharded "
                  f"== the mesh of one (resident on cuda:0), "
                  f"count_bg_kmers_sharded == native count_kmers (three "
                  f"launches a card)", flush=True)

    memes = {}
    with phase(names[2]):
        for fasta, w, stem in ((mafk, "8", "mafk_w8"),
                               (mafk, "10", "mafk_w10"),
                               (mafk100, "12", "mafk100_w12"),
                               (large_fasta, "10", "large_w10"),
                               (large_fasta, "12", "large_w12")):
            runs = {}
            for m in [None] + sizes:
                log = io.StringIO()
                out = os.path.join(tmp, f"cards_{stem}_{m}.meme")
                js = os.path.join(tmp, f"cards_{stem}_{m}.json")
                watch = CardWatch(range(1, m or 1))
                zero_launches()
                with watch.active():
                    wall, timing = run_cli(
                        [fasta, "-w", w, "--device", "cuda", "--engine",
                         "tpu", "--timing", "-o", out, "-j", js]
                        + (["--devices", str(m)] if m else []), log)
                launches = dict(H.DEVICE_LAUNCHES)
                assert engine.LAST_ENGINE_USED == "gpu"
                runs[m] = (read_bytes(out), read_bytes(js), log.getvalue())
                if m:
                    every_card(launches, m)
                if stem == "large_w10" and m == big:
                    rec["cli_launches"] = launches   # the main path's run
                print(f"  {stem} --devices {m or '(none)'}: wall {wall:.3f} "
                      f"s, count {timing.get('count', 0):.1f} ms, launches "
                      f"by card {launches}", flush=True)
            for m in sizes:
                assert runs[m] == runs[None], \
                    f"{stem} --devices {m}: MEME, JSON or stdout differs"
            memes[stem] = runs[None]
            print(f"  {stem}: MEME and JSON bytes and stdout of --devices "
                  f"{sizes} identical to the run without --devices; nothing "
                  f"after the count touched cuda:1-{big - 1}", flush=True)
        golden = read_bytes(os.path.join(GOLDEN, "mafk_w8.meme"))
        with count_on("device"):
            for m in sizes:
                out = os.path.join(tmp, f"cards_exact_{m}.meme")
                zero_launches()
                run_cli([mafk, "-w", "8", "--device", "cuda", "--engine",
                         "exact", "--devices", str(m), "-o", out])
                assert engine.LAST_ENGINE_USED == "exact"
                # the batch count and the three background tables
                every_card(dict(H.DEVICE_LAUNCHES), m, each=4)
                assert read_bytes(out) == golden, \
                    f"exact --devices {m}: not the golden bytes"
        print(f"  MafK -w 8 --engine exact, count on the cards, --devices "
              f"{sizes}: byte-identical to golden, four launches a card",
              flush=True)

    with phase(names[3]):
        rec["processes"] = {}
        jobs = [(min(n, 4), 1)] + ([(2, 2)] if n >= 4 else [])
        for procs, per in jobs:
            sets = multihost.card_sets(procs * per, procs)
            stem = f"nccl_{procs}x{per}"
            wall, meme, errs, js, out = process_job(
                tmp, large_fasta, "10", stem, sets,
                devices=per if per > 1 else None)
            reps = rank_reports(errs)
            same = (meme, js, out) == memes["large_w10"]
            print(f"  {procs} processes x {per} card(s) ({sets}), 51.2 "
                  f"Mbases -w 10: job wall {wall:.3f} s (--timing of "
                  f"process 0: {timing_of(errs[0])}); MEME and JSON bytes "
                  f"and stdout identical to the single-process run {same}",
                  flush=True)
            for r in reps:
                print(f"    rank {r['rank']}: chunk rows {r['rows']} on "
                      f"{r['devices']} x {r['device']}, launches "
                      f"{r['launches']} {r['tier_launches']}, backend "
                      f"{r['backend']}", flush=True)
                assert r["backend"] == "nccl", r
                assert r["device"] == "cuda" and r["devices"] == per, r
                assert r["launches"] > 0, r
            assert reps[0]["rows"][0] == 0
            assert all(a["rows"][1] == b["rows"][0]
                       for a, b in zip(reps, reps[1:]))
            assert same, f"{stem}: MEME, JSON or stdout differs"
            rec["processes"][stem] = dict(wall_s=wall, ranks=reps)

    with phase(names[4]):
        for m in sizes:
            zero_launches()
            with contextlib.redirect_stdout(io.StringIO()):
                dryrun_multichip(m, "cuda")
            every_card(dict(H.DEVICE_LAUNCHES), m)
            print(f"  dryrun_multichip({m}, cuda): MEME bytes and stdout "
                  f"over cuda:0-{m - 1} identical to the one-card run",
                  flush=True)
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs a CUDA device", file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    # the phases measure the kernel at full width on the whole corpus:
    # the count is pinned to the card for them (the processes they start
    # count at W <= 10, where the rule takes the card too); phase 12 owns
    # the rule
    global RULE
    from peng_motif_tpu_torch.ops import hybrid

    RULE = hybrid.count_on_host
    hybrid.count_on_host = lambda *a: False

    import numpy as np

    from peng_motif_tpu_torch import engine
    from peng_motif_tpu_torch.bench_histogram import (EDGE_NAMES, bound_ms,
                                                      edge_tensors,
                                                      time_in_turns)
    from peng_motif_tpu_torch.device import resolve_device
    from peng_motif_tpu_torch.io.fasta import load_sequence_set
    from peng_motif_tpu_torch.models.background import BackgroundModel
    from peng_motif_tpu_torch.native import get_lib
    from peng_motif_tpu_torch.ops import histogram as H

    kernel_ms = plain_ms = library_ms = bound = None
    max_err = 0

    with phase("device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
        # name, power limit: as nvidia-smi gives them, one line a card
        for card in smi.stdout.strip().splitlines():
            print(card, flush=True)
        dev = resolve_device("cuda")
        kind = torch.cuda.get_device_name(0)
        print(f"torch: {torch.__version__} cuda {torch.version.cuda} "
              f"device {kind} count {torch.cuda.device_count()}", flush=True)
        if torch.cuda.device_count() > 1:
            from peng_motif_tpu_torch.bench_histogram import links

            print(links(), flush=True)

    with phase("build"):
        t0 = time.perf_counter()
        H.build_kernels()
        t1 = time.perf_counter()
        get_lib()
        t2 = time.perf_counter()
        print(f"histogram kernel (nvcc sm_90a): {t1 - t0:.3f} s; native "
              f"library (g++): {t2 - t1:.3f} s", flush=True)
        for line in H.BUILD_LOG.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}", flush=True)

    tiers = {}
    with phase("kernel vs plain, synthetic ids"):
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        n = 50_000_000
        for n_bins in (384, 4 ** 6, 4 ** 7, H.SHARED_MAX_BINS, 4 ** 8,
                       4 ** 9, 4 ** 10, 4 ** 12):
            ids = torch.randint(0, n_bins, (n,), generator=gen, device=dev,
                                dtype=torch.int32)
            inc = torch.rand(n, generator=gen, device=dev) < 0.8
            p = H.plan(n_bins, n)
            tiers[str(n_bins)] = (
                f"{p.tier}, {p.slices} slice(s) of {p.shared_bytes} B"
                if p.tier == "shared" else
                f"{p.tier}, {len(p.ranges)} pass(es)")
            before = H.LAUNCHES
            k_ms, p_ms, same, err, lib_ms = time_pair(ids, inc, n_bins,
                                                      library=True)
            max_err = max(max_err, err)
            b_ms = bound_ms(n, n_bins)
            print(f"  n_bins={n_bins:>9} n={n} counted=80% "
                  f"[{tiers[str(n_bins)]}]: kernel {k_ms:.4f} ms "
                  f"({100 * b_ms / k_ms:.1f}% of the {b_ms:.4f} ms bound), "
                  f"plain {p_ms:.4f} ms, library {lib_ms:.4f} ms, "
                  f"bit-identical {same}", flush=True)
            assert same, f"kernel != plain at n_bins={n_bins}"
            assert H.LAUNCHES > before
            # the split of load cost from atomic cost: no flag set (the
            # pure load rate) and every flag set
            for label, flags in (("zero", torch.zeros_like(inc)),
                                 ("one", torch.ones_like(inc))):
                ms = time_in_turns(
                    {"kernel": lambda: H.histogram(ids, flags, n_bins)})
                print(f"    flags all {label}: kernel {ms['kernel']:.4f} "
                      f"ms ({100 * b_ms / ms['kernel']:.1f}% of bound)",
                      flush=True)
            del ids, inc
        for n_bins in (384, 4 ** 8, 4 ** 10, 4 ** 12):
            for name in EDGE_NAMES:
                ids, inc = edge_tensors(name, n_bins, dev)
                got = H.histogram(ids, inc, n_bins)
                want = H.histogram_plain(ids, inc, n_bins)
                torch.cuda.synchronize()
                assert torch.equal(got, want), \
                    f"kernel != plain on edge input {name} n_bins={n_bins}"
            # out=: adds into a running table, equal to two calls summed
            ids, inc = edge_tensors("sliced_3", n_bins, dev)
            run = H.histogram(ids, inc, n_bins)
            assert H.histogram(ids, inc, n_bins, out=run) is run
            torch.cuda.synchronize()
            assert torch.equal(run, 2 * H.histogram_plain(ids, inc, n_bins))
            print(f"  n_bins={n_bins}: {len(EDGE_NAMES)} edge inputs and "
                  f"out= bit-identical", flush=True)

    chain_inputs = {}
    with phase("golden end to end (--device cuda)"):
        cases = [("mafk_w8", "MafK.fasta", "8"),
                 ("mafk_w10", "MafK.fasta", "10"),
                 ("mafk100_w8", "MafK_100seqs.fasta", "8"),
                 ("mafk100_w12", "MafK_100seqs.fasta", "12")]
        with tempfile.TemporaryDirectory() as tmp:
            for stem, fasta, w in cases:
                out = os.path.join(tmp, f"{stem}.meme")
                before = H.LAUNCHES
                crec = ChainRecorder()
                with crec.active():
                    wall, timing = run_cli([
                        os.path.join(GOLDEN, fasta), "-w", w, "--device",
                        "cuda", "--engine", "tpu", "--timing", "-o", out])
                with open(out) as f, \
                        open(os.path.join(GOLDEN, f"{stem}.meme")) as g:
                    got, want = f.read(), g.read()
                ok = within_tolerance(got, want)
                print(f"  {stem}: wall {wall:.3f} s, within tolerance {ok}, "
                      f"byte-identical {got == want}, engine "
                      f"{engine.LAST_ENGINE_USED}, climb "
                      f"{engine.LAST_CLIMB_ENGINE}, pwm "
                      f"{engine.LAST_PWM_ENGINE}, histogram launches "
                      f"{H.LAUNCHES - before}", flush=True)
                print("    --timing: " + ", ".join(
                    f"{k} {v:.1f} ms" for k, v in timing.items()), flush=True)
                assert ok, f"{stem}: MEME output outside the tolerance"
                assert engine.LAST_ENGINE_USED == "gpu"
                assert engine.LAST_CLIMB_ENGINE == "device"
                assert engine.LAST_PWM_ENGINE == "device"
                assert H.LAUNCHES > before, f"{stem}: no kernel launch"
                inp = crec.inputs()
                walls, res = run_chain(inp, dev)
                print(f"    device programs, rerun on the recorded inputs: "
                      f"{fmt_walls(walls)}; walks {res['walk_stats']}, "
                      f"ltot {inp['ltot']}, wide {inp['wide']}", flush=True)
                chain_inputs[stem] = inp

    big = tempfile.TemporaryDirectory()
    tmp = big.name
    with phase("51.2-Mbase corpus"):
        fasta = os.path.join(tmp, "large.fasta")
        t0 = time.perf_counter()
        n_bases = write_large_corpus(fasta)
        print(f"  corpus written: {n_bases} bases in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        # kernel, plain, plain, kernel: each version's wall is the mean
        # of its two runs; the first kernel run is the main-path run
        memes, recs, walls = {}, {}, {"kernel": [], "plain": []}
        launches = None
        for label in ("kernel", "plain", "plain", "kernel"):
            out = os.path.join(tmp, f"{label}.meme")
            rec = Recorder(plain=label == "plain")
            crec = ChainRecorder()
            with rec.active(), crec.active():
                if launches is None:
                    zero_launches()  # the main-path run starts here
                wall, timing = run_cli([fasta, "-w", "10", "--device",
                                        "cuda", "--engine", "tpu", "--timing",
                                        "-o", out])
                if launches is None:
                    launches = H.LAUNCHES
                    tier_launches = dict(H.TIER_LAUNCHES)
                    card_launches = dict(H.DEVICE_LAUNCHES)
                    chain_inputs["large_w10"] = crec.inputs()
            assert engine.LAST_CLIMB_ENGINE == "device"
            assert engine.LAST_PWM_ENGINE == "device"
            assert engine.LAST_ENGINE_USED == "gpu"
            with open(out, "rb") as f:
                meme = f.read()
            assert memes.setdefault(label, meme) == meme
            recs.setdefault(label, rec)
            walls[label].append((wall, rec.count_s))
            print(f"  w10 {label:>6} histogram: end-to-end wall {wall:.3f} "
                  f"s, count phase {rec.count_s:.3f} s = "
                  f"{n_bases / rec.count_s / 1e6:.2f} Mbases/s, ltot "
                  f"{rec.ltot}; --timing: " + ", ".join(
                      f"{k} {v:.1f} ms" for k, v in timing.items()),
                  flush=True)
        for label, runs in walls.items():
            e2e = sum(r[0] for r in runs) / len(runs)
            cnt = sum(r[1] for r in runs) / len(runs)
            print(f"  w10 {label:>6} mean of 2: end-to-end {e2e:.3f} s, "
                  f"count phase {cnt:.3f} s = {n_bases / cnt / 1e6:.2f} "
                  f"Mbases/s", flush=True)
        print(f"  w10 main-path histogram launches: {launches} "
              f"{tier_launches}", flush=True)
        assert launches == sum(tier_launches.values())
        assert all(v > 0 for v in tier_launches.values()), \
            "a kernel of the main path was launched no time"
        assert same_record(recs["kernel"], recs["plain"]), \
            "w10: kernel and plain count tables differ"
        assert memes["kernel"] == memes["plain"], "w10: MEME bytes differ"
        print("  w10 kernel vs plain: count table, ltot, background counts "
              "and MEME bytes identical", flush=True)
        scale_rec = recs["kernel"]

        # the kernel on the exact inputs the main path handed it
        main_inputs = recs["kernel"].inputs
        for n_bins, (ids, inc) in sorted(main_inputs.items()):
            k_ms, p_ms, same, err, lib_ms = time_pair(ids, inc, n_bins,
                                                      library=True)
            max_err = max(max_err, err)
            b_ms = bound_ms(ids.numel(), n_bins)
            print(f"  main-path input n_bins={n_bins} n={ids.numel()} "
                  f"counted={int(inc.sum())} (input L2-resident): kernel "
                  f"{k_ms:.4f} ms ({100 * b_ms / k_ms:.1f}% of the "
                  f"{b_ms:.4f} ms bound), plain {p_ms:.4f} ms, library "
                  f"{lib_ms:.4f} ms, bit-identical {same}", flush=True)
            assert same, f"kernel != plain on the main-path input {n_bins}"
            if n_bins == 4 ** 10:
                kernel_ms, plain_ms, library_ms, bound = (k_ms, p_ms, lib_ms,
                                                          b_ms)
        assert kernel_ms is not None, "no 4**10 table in the main path"
        scale_rec.inputs = {}
        del main_inputs

        sset = load_sequence_set(fasta)
        recs = {}
        # a warm-up run first: the first 4**12 count also builds the
        # host-side id tables for that width
        for label in ("warm-up", "kernel", "plain", "plain", "kernel"):
            rec = Recorder(plain=label == "plain")
            peng = types.SimpleNamespace(
                sequence_set=sset,
                bg_model=BackgroundModel(sset.sequences, order=2,
                                         interpolate=True, defer=True))
            before = H.LAUNCHES
            with rec.active():
                engine._count_phase(peng, 12, True, dev)
            recs.setdefault(label, rec)
            print(f"  w12 {label:>7} histogram: count phase "
                  f"{rec.count_s:.3f} s = "
                  f"{n_bases / rec.count_s / 1e6:.2f} Mbases/s, ltot "
                  f"{rec.ltot}, histogram launches {H.LAUNCHES - before}",
                  flush=True)
        assert same_record(recs["kernel"], recs["plain"]), \
            "w12: kernel and plain count tables differ"
        print("  w12 kernel vs plain: count table, ltot and background "
              "counts identical", flush=True)
        assert int(np.asarray(recs["kernel"].counts).sum()) > 0

    with phase("post-count chain, card against CPU"):
        for stem, wide in (("mafk_w10", False), ("large_w10", True)):
            inp = chain_inputs[stem]
            assert inp["wide"] == wide, (stem, inp["wide"])
            assert inp["adv"] is not None and inp["em"] is not None, stem
            res = {}
            for d in (dev, "cpu"):
                walls, res[str(d)] = run_chain(inp, d)
                print(f"  {stem} (wide {wide}) on {d}: {fmt_walls(walls)}; "
                      f"walks {res[str(d)]['walk_stats']}, motifs "
                      f"{inp['adv'][0].shape[0]}, EM iterations "
                      f"{res[str(d)]['em'][1].tolist()}", flush=True)
            compare_chains(res[str(dev)], res["cpu"])
            print(f"  {stem}: walk trace integers identical, floats within "
                  "tolerance; adv-PWMs bit-identical; EM within 5e-6, "
                  "same iterations", flush=True)

    em_rec = run_em_phase(big.name, dev)
    climb_rec = run_climb_phase(big.name, dev)
    exact = run_exact_phase(big.name, fasta)
    max_err = max(max_err, exact["max_abs_err"])
    mesh = run_mesh_phase(big.name, fasta, dev, n_bases)
    max_err = max(max_err, mesh.pop("max_abs_err"))
    procs = run_process_phase(big.name, fasta, dev, scale_rec)
    run_parity_phase(big.name)
    entry = run_entry_phase(dev)
    max_err = max(max_err, entry["entry"]["max_abs_err"])
    hybrid = run_hybrid_phase(big.name, fasta, dev, n_bases)
    run_shoot_phase(big.name)
    cards = run_cards_phase(big.name, fasta, dev)
    if cards is not None:
        max_err = max(max_err, cards.pop("max_abs_err"))
    big.cleanup()
    print(f"all phases done in {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # launches / ms / plain_ms / library_ms / bound_ms: the device engine's
    # main path (51.2 Mbases -w 10, the first slab's 4**10 table; bound
    # from its bytes: 5 B per input and 4 B per bin at 3.35 TB/s);
    # exact_*: the exact engine's batch device count on the same corpus;
    # tier_launches: the main path's launches per kernel (the background
    # table goes to the shared tier, the 4**10 table to the L2 tier);
    # tiers: what the dispatcher took per table size at 50M ids; mesh:
    # the sharded call sites (launches of the mesh-of-4 count and of the
    # --devices 1 main path, each counted from 0; the kernel on one
    # shard's inputs); processes: each rank's own report of the 2-process
    # jobs (rows counted, launches, transport), the kernel on one rank's
    # block, and the transport and launches of the world of one;
    # entry_launches / entry: graft_entry.entry()'s one launch (counted
    # from 0) and the kernel on its input; hybrid: the count phase's walls
    # at either end by corpus size with the two ends' rates and fixed
    # costs fitted to them, the end the rule takes, the launches at each
    # end, and the walls of the rule's end against the card;
    # card_launches: the main path's launches by card index; cards (null
    # on one card): the multi-card phase's launches by card of each run
    # (the --devices main path's run in cli_launches), the kernel on each
    # card's own inputs, and every rank's report of the NCCL jobs;
    # em_round: EM's round kernel on MafK's w10 / w12 EM inputs (motifs,
    # rounds, iterations, the kernel's and the plain torch round's wall a
    # round, the kernel's device ms a round by kernel, the bound of 8 B an
    # id at 3.35 TB/s); climb_step: the climb's aggregates kernel on MafK's
    # w10 / w12 walk inputs (walks, steps, the rows it read and their bytes,
    # its device ms a step, the walks' wall a step against the dense torch
    # step's, the bound of the rows' bytes at 3.35 TB/s a step)
    print(json.dumps({"kernels": [{
        "name": "histogram", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "tier_launches": tier_launches, "card_launches": card_launches,
        "max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": "bytes", "library_ms": library_ms,
        "tiers": tiers,
        "exact_launches": exact["launches"], "exact_ms": exact["ms"],
        "exact_plain_ms": exact["plain_ms"],
        "exact_bound_ms": exact["bound_ms"],
        "exact_library_ms": exact["library_ms"],
        "mesh": mesh, "processes": procs,
        "entry_launches": entry["entry_launches"], "entry": entry["entry"],
        "hybrid": hybrid, "cards": cards}, {
        "name": "em_round", "route": "cuda", "source": EM_SOURCE,
        "replaces": "the torch round of ops/em.py (no Pallas kernel)",
        **em_rec}, {
        "name": "climb_step", "route": "cuda", "source": CLIMB_SOURCE,
        "replaces": "the dense torch step of ops/climb.py (no Pallas "
                    "kernel)", **climb_rec}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
