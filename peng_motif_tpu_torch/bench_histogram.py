"""Measurements of the histogram kernels on one CUDA card, and of the
count over several.

    python -m peng_motif_tpu_torch.bench_histogram check
    python -m peng_motif_tpu_torch.bench_histogram tiers [--parent DIR]
    python -m peng_motif_tpu_torch.bench_histogram walls --repo DIR [--runs N]
    python -m peng_motif_tpu_torch.bench_histogram mesh [--runs N]

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
``mesh``   the count over the cards of one machine (two or more; the
           four-card legs with four): the job wall and the --timing
           "count" wall of the CLI with --devices 1, 2, 4 in turns on the
           51.2-Mbase corpus at -w 10 and -w 12 and on the same
           generator's 204.8-Mbase corpus (100,000 rows, seed 7) at -w 10,
           with the scaling efficiency wall(1) / (m wall(m)); the count of
           each of those traced with torch.profiler on a mesh of one and
           of all cards (kernel time, kernel window and copies per card,
           and the time two cards or more count at once); the copies of a
           4**10 and a 4**12 table onto card 0 (parallel/sharded.
           _sum_on_first); one NCCL all-reduce of each table over one
           process a card; the job walls, process start to exit, of
           --num-processes with one card a process against --devices in
           one process and against one card.  Prints every card's name,
           power limit and the links between the cards (:func:`links`)
           first, and everything as one JSON line last.

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


def links() -> str:
    """What the machine says of the links between its cards: ``nvidia-smi
    topo -m`` and ``nvidia-smi nvlink --status``, each with its exit code
    (a machine may refuse either, as one four-card H100 host refuses
    ``topo -m``; the refusal is reported, not raised), and torch's
    peer-access matrix."""
    import torch

    out = []
    for cmd in (["nvidia-smi", "topo", "-m"],
                ["nvidia-smi", "nvlink", "--status"]):
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
        out.append(f"$ {' '.join(cmd)} (exit {p.returncode})\n"
                   + (p.stdout + p.stderr).strip())
    n = torch.cuda.device_count()
    out.append("peer access (torch.cuda.can_device_access_peer, row to "
               "column): " + "; ".join(
                   f"cuda:{i} " + "".join(
                       "-" if i == j else
                       "y" if torch.cuda.can_device_access_peer(i, j)
                       else "n" for j in range(n)) for i in range(n)))
    return "\n".join(out)


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


def _median_range(xs):
    import statistics

    return dict(median=statistics.median(xs), lo=min(xs), hi=max(xs),
                runs=len(xs))


def _cli_wall(argv):
    """(job wall s, --timing "count" s) of one in-process CLI run."""
    import contextlib
    import io

    from .cli import main

    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        rc = main(argv + ["--timing"])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"CLI exited {rc}: {argv}\n{err.getvalue()}")
    for line in err.getvalue().splitlines():
        if line.startswith("[TIMING] count: "):
            return wall, float(line.split(": ")[1].split()[0]) / 1e3
    raise RuntimeError(f"no count timing in:\n{err.getvalue()}")


def mesh_walls(corpora, meshes, runs):
    """{corpus label: {mesh size: {"job": ..., "count": ...}}}: the CLI
    (device engine, --devices m) in turns over the mesh sizes, forward
    then backward, after one warm-up run each."""
    out = {}
    for label, (fasta, w) in corpora.items():
        argv = [fasta, "-w", str(w), "--device", "cuda", "--engine", "tpu",
                "-o", os.devnull]
        walls = {m: [] for m in meshes}
        for m in meshes:
            _cli_wall(argv + ["--devices", str(m)])
        for i in range(runs):
            for m in (meshes if i % 2 == 0 else meshes[::-1]):
                walls[m].append(_cli_wall(argv + ["--devices", str(m)]))
        out[label] = {m: {"job": _median_range([w[0] for w in ws]),
                          "count": _median_range([w[1] for w in ws])}
                      for m, ws in walls.items()}
        for m, r in out[label].items():
            base = out[label][meshes[0]]
            eff = {k: base[k]["median"] / (m * r[k]["median"])
                   for k in ("job", "count")}
            r["efficiency"] = eff
            print(f"  {label} --devices {m}: job {r['job']['median']:.4f} s "
                  f"({r['job']['lo']:.4f}-{r['job']['hi']:.4f}), count "
                  f"{r['count']['median']:.4f} s ({r['count']['lo']:.4f}-"
                  f"{r['count']['hi']:.4f}), {r['job']['runs']} runs; "
                  f"scaling efficiency wall(1)/(m wall(m)): job "
                  f"{eff['job']:.3f}, count {eff['count']:.3f}", flush=True)
    return out


def trace_count(fasta, w, mesh, path):
    """The sharded stream count of ``fasta`` at ``w`` over ``mesh`` (and
    the fetch the engine makes of it), traced by torch.profiler.  Per
    card: kernel time, the window from its first to its last kernel, and
    its copies (kind, bytes, time); and the time at least two cards
    counted at once."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .engine import _fetch
    from .io.fasta import load_sequence_set
    from .parallel.sharded import stream_count_sharded

    ss = load_sequence_set(fasta)

    def count():
        out = stream_count_sharded(ss.sequences, w, True, mesh,
                                   flat_codes=ss._flat_codes, bg_order=2,
                                   n_undefined=ss.n_undefined)[2]
        _fetch(out)

    count()
    for d in set(mesh):
        torch.cuda.synchronize(d)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        count()
        for d in set(mesh):
            torch.cuda.synchronize(d)
    wall = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    cards = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in ("kernel",
                                                      "gpu_memcpy"):
            continue
        dev = int(e.get("args", {}).get("device", e.get("pid", -1)))
        c = cards.setdefault(dev, {"kernel_us": 0.0, "kernels": 0,
                                   "spans": [], "copies": {}})
        if e["cat"] == "kernel":
            c["kernel_us"] += e["dur"]
            c["kernels"] += 1
            c["spans"].append((e["ts"], e["ts"] + e["dur"]))
        else:
            cp = c["copies"].setdefault(e["name"],
                                        {"n": 0, "bytes": 0, "us": 0.0})
            cp["n"] += 1
            cp["bytes"] += int(e.get("args", {}).get("bytes", 0))
            cp["us"] += e["dur"]
    if not any(c["kernels"] for c in cards.values()):
        raise RuntimeError("the trace holds no kernel on any card")
    t_first = min(s[0] for c in cards.values() for s in c["spans"])
    # time with at least two cards inside a kernel, from the spans' edges
    edges = sorted((t, +1 if k == 0 else -1) for c in cards.values()
                   for s in c["spans"] for k, t in enumerate(s))
    both, busy_cards, last = 0.0, 0, None
    per_card_busy = {d: _union(c["spans"]) for d, c in cards.items()}
    for t, step in edges:
        if busy_cards >= 2 and last is not None:
            both += t - last
        busy_cards += step
        last = t
    for d, c in sorted(cards.items()):
        sp = c.pop("spans")
        c["window_us"] = ((min(s[0] for s in sp) - t_first,
                           max(s[1] for s in sp) - t_first) if sp else None)
        c["busy_us"] = per_card_busy[d]
    return dict(wall_s=wall, cards=cards, two_or_more_busy_us=both)


def _union(spans):
    """Microseconds covered by the union of (start, end) spans."""
    total, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def peer_copies(meshes_max):
    """ms of one copy of a 4**10 and a 4**12 int32 table from each card
    k > 0 to card 0 (the copies of parallel/sharded._sum_on_first; on the
    source card's stream, where torch runs a copy between cards), and of
    ``_sum_on_first`` itself over all the cards."""
    import torch

    from .parallel.sharded import _sum_on_first

    out = {}
    mesh = tuple(torch.device("cuda", k) for k in range(meshes_max))
    for W in (10, 12):
        nbytes = 4 * 4 ** W
        row = {"bytes": nbytes, "copy_ms": {}}
        for k in range(1, meshes_max):
            src = torch.ones(4 ** W, dtype=torch.int32, device=mesh[k])
            for _ in range(3):
                src.to(mesh[0])
            torch.cuda.synchronize(k)
            torch.cuda.synchronize(0)
            stream = torch.cuda.current_stream(mesh[k])
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            with torch.cuda.device(k):
                start.record(stream)
                for _ in range(20):
                    src.to(mesh[0])
                stop.record(stream)
            torch.cuda.synchronize(k)
            row["copy_ms"][k] = start.elapsed_time(stop) / 20
        walls = []
        for _ in range(10):
            parts = [torch.ones(4 ** W, dtype=torch.int32, device=d)
                     for d in mesh]
            for d in mesh:
                torch.cuda.synchronize(d)
            t0 = time.perf_counter()
            total = _sum_on_first(parts, mesh)
            torch.cuda.synchronize(0)
            walls.append((time.perf_counter() - t0) * 1e3)
            assert int(total[0]) == meshes_max
        row["sum_on_first_ms"] = _median_range(walls)
        row["sum_on_first_bytes"] = (meshes_max - 1) * nbytes
        out[W] = row
        print(f"  4**{W} int32 table ({nbytes} B): one copy card k -> card 0 "
              + ", ".join(f"k={k} {v:.4f} ms ({nbytes / v / 1e6:.1f} GB/s)"
                          for k, v in row["copy_ms"].items())
              + f"; _sum_on_first over {meshes_max} cards "
              f"({row['sum_on_first_bytes']} B copied) median "
              f"{row['sum_on_first_ms']['median']:.4f} ms", flush=True)
    return out


_NCCL = r"""
import json, sys, time
import torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[4])
from peng_motif_tpu_torch.parallel import multihost as mh
coord, world, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
dev = torch.device("cuda", 0)
ctx = mh.init_multihost(coord, world, rank, timeout_s=120, device=dev,
                        mesh=(dev,))
out = {"backend": ctx.backend}
try:
    for W in (10, 12):
        t = torch.ones(4 ** W, dtype=torch.int32, device=dev)
        assert int(mh._all_reduce_sum(ctx, t)[0]) == world
        t.zero_()
        for _ in range(3):
            mh._all_reduce_sum(ctx, t)
        ms = []
        for _ in range(20):
            torch.cuda.synchronize()
            dist.barrier(group=ctx.group)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            mh._all_reduce_sum(ctx, t)
            stop.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(stop))
        out[str(W)] = ms
finally:
    mh.shutdown_multihost()
if rank == 0:
    print(json.dumps(out))
"""


def nccl_all_reduce(world):
    """ms of one all-reduce of the 4**10 and the 4**12 int32 table over
    ``world`` processes, one card each (parallel/multihost._all_reduce_sum
    on the NCCL group that init_multihost makes), from rank 0."""
    from .parallel.multihost import card_sets

    sys.path.insert(0, REPO)
    from chip_smoke import free_port, seeing

    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _NCCL, f"localhost:{port}", str(world),
         str(r), REPO], env=seeing(cards), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for r, cards in enumerate(card_sets(world, world))]
    results = []
    try:
        for p in procs:
            results.append(p.communicate(timeout=300) + (p.returncode,))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (_, err, rc) in enumerate(results):
        if rc != 0:
            raise RuntimeError(f"NCCL rank {r} exited {rc}:\n{err[-3000:]}")
    got = json.loads(results[0][0].strip().splitlines()[-1])
    if got["backend"] != "nccl":
        raise RuntimeError(f"the ranks took {got['backend']}, not nccl")
    out = {}
    for W in (10, 12):
        out[W] = _median_range(got[str(W)])
        print(f"  NCCL all-reduce of the 4**{W} int32 table ({4 * 4 ** W} "
              f"B) over {world} processes, one card each: median "
              f"{out[W]['median']:.4f} ms ({out[W]['lo']:.4f}-"
              f"{out[W]['hi']:.4f}), 20 runs", flush=True)
    return out


def process_walls(fasta, n_cards, runs, tmp):
    """Job walls, process start to exit, of 51.2 Mbases -w 10 on the
    device engine: ``--num-processes n_cards`` with one card each,
    ``--devices n_cards`` in one process, and one process on one card,
    in turns.  Every job's MEME must equal the first one's."""
    from .parallel.multihost import card_sets

    sys.path.insert(0, REPO)
    from chip_smoke import process_job, read_bytes, seeing

    def single(m):
        out = os.path.join(tmp, f"single_{m}.meme")
        argv = [sys.executable, "-m", "peng_motif_tpu_torch", fasta, "-w",
                "10", "--device", "cuda", "--engine", "tpu", "-o", out]
        if m > 1:
            argv += ["--devices", str(m)]
        t0 = time.perf_counter()
        p = subprocess.run(argv, cwd=REPO, capture_output=True, text=True,
                           timeout=300,
                           env=seeing(",".join(map(str, range(m)))))
        if p.returncode != 0:
            raise RuntimeError(p.stderr[-3000:])
        return time.perf_counter() - t0, read_bytes(out)

    legs = {
        "one card": lambda: single(1),
        f"--devices {n_cards}": lambda: single(n_cards),
        f"--num-processes {n_cards}": lambda: process_job(
            tmp, fasta, "10", "walls", card_sets(n_cards, n_cards))[:2]}
    walls, meme = {k: [] for k in legs}, None
    for i in range(runs):
        for k in (list(legs) if i % 2 == 0 else list(legs)[::-1]):
            wall, got = legs[k]()
            meme = meme or got
            if got != meme:
                raise RuntimeError(f"{k}: MEME bytes differ")
            walls[k].append(wall)
    out = {k: _median_range(v) for k, v in walls.items()}
    for k, r in out.items():
        print(f"  51.2 Mbases -w 10, {k}: job wall median {r['median']:.3f} s "
              f"({r['lo']:.3f}-{r['hi']:.3f}), {r['runs']} runs, "
              f"process start to exit", flush=True)
    print(f"  MEME bytes identical across all {3 * runs} jobs", flush=True)
    return out


def mode_mesh(runs):
    import tempfile

    import torch

    n = torch.cuda.device_count()
    if n < 2:
        raise RuntimeError(f"mesh: needs two cards or more, found {n}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    topo = links()
    print(smi.rstrip(), flush=True)
    print(topo, flush=True)
    meshes = [1, 2] + ([4] if n >= 4 else [])
    sys.path.insert(0, REPO)
    from chip_smoke import write_large_corpus

    from .ops.histogram import build_kernels

    build_kernels()
    res = {"cards": smi.strip().splitlines(), "topology": topo}
    with tempfile.TemporaryDirectory() as tmp:
        large = os.path.join(tmp, "large.fasta")
        huge = os.path.join(tmp, "huge.fasta")
        write_large_corpus(large)
        write_large_corpus(huge, n_seq=100_000)
        print("[mesh] job and count-phase walls by mesh size", flush=True)
        res["walls"] = mesh_walls({"51.2 Mbases w10": (large, 10),
                                   "51.2 Mbases w12": (large, 12),
                                   "204.8 Mbases w10": (huge, 10)},
                                  meshes, runs)
        print("[mesh] the count traced on every card", flush=True)
        res["trace"] = {}
        for label, fasta, w in (("51.2 Mbases w10", large, 10),
                                ("51.2 Mbases w12", large, 12),
                                ("204.8 Mbases w10", huge, 10)):
            for m in (1, meshes[-1]):
                mesh = tuple(torch.device("cuda", k) for k in range(m))
                t = trace_count(fasta, w, mesh,
                                os.path.join(tmp, f"trace_{w}_{m}.json"))
                res["trace"][f"{label}, mesh {m}"] = t
                print(f"  {label}, mesh of {m}: wall {t['wall_s']:.4f} s "
                      f"(profiled), two or more cards in a kernel at once "
                      f"{t['two_or_more_busy_us'] / 1e3:.3f} ms", flush=True)
                for d, c in sorted(t["cards"].items()):
                    win = c["window_us"]
                    print(f"    cuda:{d}: {c['kernels']} kernels, "
                          f"{c['kernel_us'] / 1e3:.3f} ms in kernels (busy "
                          f"{c['busy_us'] / 1e3:.3f} ms), window "
                          + (f"{win[0] / 1e3:.3f}-{win[1] / 1e3:.3f} ms"
                             if win else "none")
                          + " from the first kernel; copies "
                          + ", ".join(f"{k} {v['n']} x, {v['bytes']} B, "
                                      f"{v['us'] / 1e3:.3f} ms"
                                      for k, v in c["copies"].items()),
                          flush=True)
        print("[mesh] peer copies onto card 0", flush=True)
        res["peer_copies"] = peer_copies(meshes[-1])
        print("[mesh] NCCL all-reduce", flush=True)
        res["nccl"] = nccl_all_reduce(meshes[-1])
        print("[mesh] job walls: processes, one process, one card",
              flush=True)
        res["processes"] = process_walls(large, meshes[-1], runs, tmp)
    print(json.dumps(res, default=str), flush=True)
    return 0


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=["check", "tiers", "walls", "mesh"])
    ap.add_argument("--parent", default=None,
                    help="tiers: a checkout whose kernel is timed as well")
    ap.add_argument("--repo", default=REPO,
                    help="walls: the checkout whose CLI is run")
    ap.add_argument("--runs", type=int, default=5,
                    help="walls, mesh: timed runs of each leg")
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
    elif args.mode == "mesh":
        rc = mode_mesh(args.runs)
    else:
        rc = mode_walls(args.repo, args.runs, args.large_fasta)
    print(f"{args.mode}: done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
