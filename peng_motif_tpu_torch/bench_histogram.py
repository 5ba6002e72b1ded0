"""Measurements of the histogram kernels on one CUDA card.

    python -m peng_motif_tpu_torch.bench_histogram check
    python -m peng_motif_tpu_torch.bench_histogram tiers [--parent DIR]
    python -m peng_motif_tpu_torch.bench_histogram walls --repo DIR [--runs N]

``check``  builds the kernels, prints what ptxas reports for each
           (registers, shared memory, spills), launches every variant of
           every table size once at full width, holds it bit-identical to
           :func:`histogram_plain`, and stops.
``tiers``  times, per table size, every variant the dispatcher could take
           (in turns, CUDA events, each call zeroing its table as
           :func:`histogram` does) on 50M uniform ids with 80% of the flags
           set, with no flag set (the pure load rate) and with every flag
           set (loads plus one atomic per id), and on the inputs the
           stream count hands the kernel for MafK.fasta at -w 6, 8 and 10
           (the CLI takes even widths only).
           Beside them: the bound from the bytes (4 B id + 1 B flag per
           input, 4 B per bin, at 3.35 TB/s), the plain version, and the
           library calls (``index_add_`` and ``bincount``).  With
           ``--parent DIR`` (a checkout of an earlier commit) that
           commit's kernel is built and timed in the same turns.
``walls``  runs the CLI of the checkout in DIR (device engine) on MafK
           -w 8, MafK -w 10 and the 51.2-Mbase corpus -w 10, warm, and
           prints the job walls as one JSON line; run it for two
           checkouts in turns to compare them.

Every mode needs a CUDA device and prints the card's name and power limit
first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")


def bound_ms(n: int, n_bins: int) -> float:
    """The least time for one call: every id (4 B) and flag (1 B) read
    once, every bin (4 B) written once, at the card's memory rate."""
    return (5 * n + 4 * n_bins) / HBM_BYTES_PER_S * 1e3


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def variants(n_bins: int, n: int):
    """{label: Plan}: the dispatcher's own choice first, then every other
    variant that can serve this table size."""
    from .ops import histogram as H

    out = {"dispatcher": H.plan(n_bins, n)}
    whole = ((0, n_bins),)
    k = -(-n_bins // H.SHARED_MAX_BINS)
    if 1 < k <= 32:
        out[f"shared, {k} slices"] = H.Plan("shared", k, whole,
                                            4 * -(-n_bins // k))
    if k > 1:
        out["l2, 1 pass"] = H.Plan("l2", 0, whole, 0)
    if 4 * n_bins > H.L2_TABLE_BYTES:
        for k in (2, 3, 4):
            out[f"l2, {k} passes"] = H.Plan("l2", 0, H._tiles(n_bins, k), 0)
    same = [k for k, v in out.items() if k != "dispatcher"
            and v == out["dispatcher"]]
    for k in same:
        del out[k]
    return out


class ParentKernel:
    """The histogram kernel of an earlier checkout (six-argument C
    interface), built beside this one's for a timing in the same turns."""

    def __init__(self, repo: str):
        from .native import BUILD_DIR, compile_library
        from .ops.histogram import _nvcc

        src = os.path.join(repo, "peng_motif_tpu_torch", "csrc",
                           "histogram.cu")
        so = os.path.join(BUILD_DIR, "libpeng_kernels_parent.so")
        compile_library(src, so, [
            _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"])
        self.lib = ctypes.CDLL(so)
        self.lib.peng_histogram.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p]
        self.lib.peng_histogram.restype = ctypes.c_int

    def __call__(self, ids, inc, n_bins):
        import torch

        out = torch.zeros(n_bins, dtype=torch.int32, device=ids.device)
        err = self.lib.peng_histogram(
            ids.data_ptr(), inc.data_ptr(), ids.numel(), out.data_ptr(),
            n_bins, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"parent kernel: CUDA error {err}")
        return out


def candidates(ids, inc, n_bins, parent=None, library=True):
    """{label: callable() -> counts} for one input: the kernel variants,
    the parent's kernel, the plain version and the library calls."""
    import torch

    from .ops import histogram as H

    inc_u8 = inc.view(torch.uint8)
    fns = {}

    def forced(p):
        def fn():
            out = torch.zeros(n_bins, dtype=torch.int32, device=ids.device)
            H.launch_plan(ids, inc_u8, n_bins, out, p)
            return out
        return fn

    for label, p in variants(n_bins, ids.numel()).items():
        fns[label] = forced(p)
    if parent is not None:
        fns["parent"] = lambda: parent(ids, inc_u8, n_bins)
    fns["plain"] = lambda: H.histogram_plain(ids, inc, n_bins)
    if library:
        fns.update(library_calls(ids, inc, n_bins))
    return fns


def library_calls(ids, inc, n_bins):
    """{label: callable}: the single PyTorch calls that compute the same
    counts, as yardsticks (the port never calls them).  ``index_add_``
    reads every id, masked ones too, so its ids are clamped into the
    table and its int32 flags prepared here, outside any timed window."""
    import torch

    inc_i32 = (inc != 0).to(torch.int32)
    ids_in = ids.clamp(0, n_bins - 1)
    counted = inc != 0
    return {
        "index_add_": lambda: torch.zeros(
            n_bins, dtype=torch.int32, device=ids.device).index_add_(
                0, ids_in, inc_i32),
        "bincount": lambda: torch.bincount(ids[counted], minlength=n_bins),
    }


def time_in_turns(fns, reps=10):
    """{label: mean ms}: every candidate timed in blocks of ``reps`` calls
    between CUDA events, once in the given order and once reversed.  Each
    block is queued behind a spin kernel of a few milliseconds, so the
    card finds the calls waiting and the time is the card's, not the
    host's enqueue rate (a short call costs the host more than the
    card)."""
    import torch

    total = {k: 0.0 for k in fns}
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    for order in (list(fns), list(reversed(fns))):
        for k in order:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(8_000_000)
            start.record()
            for _ in range(reps):
                fns[k]()
            stop.record()
            torch.cuda.synchronize()
            total[k] += start.elapsed_time(stop)
    return {k: v / (2 * reps) for k, v in total.items()}


def check_identical(fns, label):
    import torch

    want = fns["plain"]()
    for k, fn in fns.items():
        if k in ("plain", "index_add_", "bincount"):
            continue
        got = fn()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise RuntimeError(f"{label}: {k} != plain")


def report(label, n, n_bins, ms, l2_resident=False):
    b = bound_ms(n, n_bins)
    note = " (input L2-resident)" if l2_resident else ""
    print(f"  {label}: n={n} n_bins={n_bins} bound {b:.4f} ms{note}",
          flush=True)
    for k, v in ms.items():
        print(f"    {k:>18}: {v:.4f} ms, {100 * b / v:.1f}% of bound",
              flush=True)


EDGE_NAMES = (
    "empty", "all_masked", "one_hot_bin", "last_bin",
    "sliced_1", "sliced_3", "sliced_unalike",
    "n_1", "n_3", "n_4", "n_5", "n_15", "n_17", "n_3071", "n_3073",
    "n_grid_minus_1", "n_grid_plus_1",
    "masked_ids_out_of_range", "flags_2_and_255", "counted_ids_dropped",
    "one_bin_many")


def edge_input(name, n_bins, seed=0, many=1 << 24):
    """One edge input of the histogram as numpy arrays: (ids int32, inc
    bool or uint8, ids_off, inc_off).  The caller makes tensors of the
    arrays and slices them ``[off:]``, so that the kernel sees pointers
    off their 16-byte and 4-byte alignment; both slices have one length.
    ``many``: the length of the all-in-one-bin input."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def rand(n, frac=0.8):
        return (rng.integers(0, n_bins, size=n).astype(np.int32),
                rng.random(n) < frac)

    if name == "empty":
        return np.zeros(0, np.int32), np.zeros(0, bool), 0, 0
    if name == "all_masked":
        return rand(1 << 16)[0], np.zeros(1 << 16, bool), 0, 0
    if name == "one_hot_bin":
        return (np.full(1 << 16, n_bins // 3, np.int32),
                rng.random(1 << 16) < 0.9, 0, 0)
    if name == "last_bin":
        ids, inc = rand(1 << 16, 0.5)
        ids[::5] = n_bins - 1
        return ids, inc, 0, 0
    if name.startswith("sliced_"):
        # the alignment prologue: ids[1:], ids[3:] with the flags sliced
        # alike, and ids[1:] against inc[2:] (flags not readable as words)
        ids, inc = rand((1 << 16) + 7)
        if name == "sliced_unalike":
            return ids[:-1], inc, 1, 2
        off = int(name[-1])
        return ids, inc, off, off
    if name.startswith("n_"):
        # lengths around the 4-id vector, the 256-thread step of the old
        # kernel and one full trip of the persistent grid
        grid = 4 * 4 * 1024 * 132
        n = {"grid_minus_1": grid - 1, "grid_plus_1": grid + 1}.get(
            name[2:]) or int(name[2:])
        return (*rand(n), 0, 0)
    if name == "masked_ids_out_of_range":
        ids, inc = rand(1 << 16, 0.5)
        junk = rng.choice(np.array(
            [-1, -(2 ** 31), n_bins, 2 ** 31 - 1], np.int64),
            size=ids.size).astype(np.int32)
        return np.where(inc, ids, junk), inc, 0, 0
    if name == "flags_2_and_255":
        ids, inc = rand(1 << 16, 0.6)
        return (ids, (inc * rng.choice(np.array([2, 255], np.uint8),
                                       size=ids.size)).astype(np.uint8),
                0, 0)
    if name == "counted_ids_dropped":
        ids, inc = rand(1 << 16)
        ids[::7] = n_bins
        ids[3::11] = -1
        ids[5::13] = 2 ** 31 - 1
        return ids, inc, 0, 0
    assert name == "one_bin_many", name
    return (np.full(many, n_bins - 2, np.int32), np.ones(many, bool), 0, 0)


def edge_tensors(name, n_bins, device, seed=0, many=1 << 24):
    """:func:`edge_input` as tensors on ``device``, sliced."""
    import torch

    ids, inc, i_off, f_off = edge_input(name, n_bins, seed, many)
    return (torch.from_numpy(ids).to(device)[i_off:],
            torch.from_numpy(inc).to(device)[f_off:])


SIZES = (384, 4 ** 6, 4 ** 7, 58_112, 4 ** 8, 4 ** 9, 4 ** 10, 4 ** 12)


def synthetic(n_bins, n, gen, dev):
    import torch

    ids = torch.randint(0, n_bins, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    inc = torch.rand(n, generator=gen, device=dev) < 0.8
    return ids, inc


def main_path_inputs(widths=(6, 8, 10)):
    """{(W, n_bins): (ids, inc)}: the first input of each table size
    that the stream count hands the histogram for MafK.fasta."""
    import contextlib
    import io
    import tempfile

    from .cli import main
    from .ops import stream_count

    got = {}
    real = stream_count.histogram
    for w in widths:
        def capture(ids, inc, n_bins, out=None, w=w):
            got.setdefault((w, n_bins), (ids.clone(), inc.clone()))
            return real(ids, inc, n_bins, out=out)

        stream_count.histogram = capture
        err = io.StringIO()
        try:
            with tempfile.TemporaryDirectory() as tmp, \
                    contextlib.redirect_stdout(io.StringIO()), \
                    contextlib.redirect_stderr(err):
                try:
                    rc = main([os.path.join(GOLDEN, "MafK.fasta"), "-w",
                               str(w), "--device", "cuda", "--engine", "tpu",
                               "--no-em", "-o", os.path.join(tmp, "o.meme")])
                except SystemExit as e:
                    rc = e.code
            if rc != 0:
                raise RuntimeError(f"CLI exited {rc}:\n{err.getvalue()}")
        finally:
            stream_count.histogram = real
    return got


def mode_check():
    import torch

    from .ops import histogram as H

    H.build_kernels()
    for line in H.BUILD_LOG.splitlines():
        if any(s in line for s in ("registers", "spill", "Function prop",
                                   "Compiling entry")):
            print(f"  ptxas: {line.strip()}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for n_bins in SIZES:
        for n in (1 << 22, (1 << 22) + 3):
            ids, inc = synthetic(n_bins, n, gen, dev)
            for sl in (0, 1, 3):
                fns = candidates(ids[sl:], inc[sl:], n_bins, library=False)
                check_identical(fns, f"n_bins={n_bins} n={n} slice {sl}")
        # ids and flags sliced unalike: the flags cannot be read as words
        fns = candidates(ids[1:-1], inc[2:], n_bins, library=False)
        check_identical(fns, f"n_bins={n_bins} unalike slices")
        print(f"  n_bins={n_bins}: {sorted(set(fns) - {'plain'})} "
              f"bit-identical to plain", flush=True)
    return 0


def mode_tiers(parent_dir):
    import torch

    dev = torch.device("cuda")
    parent = ParentKernel(parent_dir) if parent_dir else None
    for (w, n_bins), (ids, inc) in sorted(main_path_inputs().items()):
        fns = candidates(ids, inc, n_bins, parent)
        check_identical(fns, f"MafK w{w} n_bins={n_bins}")
        report(f"MafK -w {w} stream-count input, counted "
               f"{int(inc.sum())}", ids.numel(), n_bins,
               time_in_turns(fns, reps=50), l2_resident=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n = 50_000_000
    for n_bins in SIZES:
        ids, inc = synthetic(n_bins, n, gen, dev)
        fns = candidates(ids, inc, n_bins, parent)
        check_identical(fns, f"n_bins={n_bins}")
        report("80% counted", n, n_bins, time_in_turns(fns))
        for label, flags in (("flags all zero", torch.zeros_like(inc)),
                             ("flags all one", torch.ones_like(inc))):
            fns = candidates(ids, flags, n_bins, parent, library=False)
            del fns["plain"]
            report(label, n, n_bins, time_in_turns(fns))
        # every input in one bin: the worst case of a shared-memory copy
        hot = torch.full((1 << 24,), n_bins // 3, dtype=torch.int32,
                         device=dev)
        fns = candidates(hot, torch.ones_like(hot, dtype=torch.bool), n_bins,
                         parent, library=False)
        check_identical(fns, f"n_bins={n_bins} one hot bin")
        del fns["plain"]
        report("one hot bin, flags all one", hot.numel(), n_bins,
               time_in_turns(fns))
        del ids, inc, hot, fns
    return 0


_WALLS = r"""
import contextlib, io, json, os, sys, time
sys.path.insert(0, os.getcwd())
from peng_motif_tpu_torch.cli import main
cases, runs = json.loads(sys.argv[1]), int(sys.argv[2])
out = {}
for name, argv in cases.items():
    walls = []
    for i in range(runs + 1):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = main(argv)
        assert rc == 0, (name, rc)
        if i:                       # the first run warms up
            walls.append(time.perf_counter() - t0)
    out[name] = walls
print(json.dumps(out))
"""


def mode_walls(repo, runs, large_fasta):
    if large_fasta is None:
        import tempfile

        sys.path.insert(0, REPO)
        from chip_smoke import write_large_corpus

        with tempfile.TemporaryDirectory() as tmp:
            large_fasta = os.path.join(tmp, "large.fasta")
            write_large_corpus(large_fasta)
            return mode_walls(repo, runs, large_fasta)
    mafk = os.path.join(GOLDEN, "MafK.fasta")
    common = ["--device", "cuda", "--engine", "tpu", "-o", os.devnull]
    cases = {"MafK w8": [mafk, "-w", "8"] + common,
             "MafK w10": [mafk, "-w", "10"] + common,
             "51.2 Mbases w10": [large_fasta, "-w", "10"] + common}
    proc = subprocess.run(
        [sys.executable, "-c", _WALLS, json.dumps(cases), str(runs)],
        cwd=repo, capture_output=True, text=True, timeout=1800)
    if proc.returncode != 0:
        raise RuntimeError(f"walls run in {repo} failed:\n{proc.stderr}")
    walls = json.loads(proc.stdout.strip().splitlines()[-1])
    print(json.dumps({"repo": repo, "walls_s": walls}), flush=True)
    return 0


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=["check", "tiers", "walls"])
    ap.add_argument("--parent", default=None,
                    help="tiers: a checkout whose kernel is timed as well")
    ap.add_argument("--repo", default=REPO,
                    help="walls: the checkout whose CLI is run")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--large-fasta", default=None,
                    help="walls: the 51.2-Mbase corpus (default: written "
                         "anew by chip_smoke.py's write_large_corpus)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_histogram: needs a CUDA device", file=sys.stderr)
        return 2
    print(card(), flush=True)
    t0 = time.perf_counter()
    if args.mode == "check":
        rc = mode_check()
    elif args.mode == "tiers":
        rc = mode_tiers(args.parent)
    else:
        rc = mode_walls(args.repo, args.runs, args.large_fasta)
    print(f"{args.mode}: done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
