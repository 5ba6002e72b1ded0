"""The port's multi-process count (peng_motif_tpu_torch/parallel/
multihost.py) through its CLI: N local processes joined by
torch.distributed over gloo on the CPU, each driving a local mesh of
virtual shards.  Process 0's output must be byte-identical to the
single-process golden files (the exact engine; the device engine within
the ENGINE_CASES tolerance); worker processes print nothing and write
nothing.  Counterpart of tests/test_multihost.py of the reference
package.

Every subprocess has its own timeout, so no case can hang the suite.
"""

import io
import os
import re
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from conftest import GOLDEN_DIR
from test_torch_engine import _assert_within_tol, _read

from peng_motif_tpu.io import fasta as jfasta
from peng_motif_tpu.ops import stream_count as jsc
from peng_motif_tpu_torch.io import fasta as tfasta
from peng_motif_tpu_torch.models import background as tbg
from peng_motif_tpu_torch.parallel import multihost as mh
from peng_motif_tpu_torch.parallel.mesh import make_data_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAFK100 = os.path.join(GOLDEN_DIR, "MafK_100seqs.fasta")
BIND_FAILURES = ("Address already in use", "EADDRINUSE")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_multihost(n_proc, fasta, w, out0, devices=None, extra=(),
                   timeout=240):
    """Launch the n-process job; returns process 0's (stdout, stderr)
    and the workers' outputs.  _free_port() closes its probe socket
    before the rendezvous binds it, so another process can take the
    port: the launch is repeated once on a fresh port, and only when a
    process's stderr shows the bind failure."""
    env = dict(os.environ, PYTHONPATH=REPO)
    devices = devices or [None] * n_proc

    def launch(pid, port):
        argv = [sys.executable, "-m", "peng_motif_tpu_torch", fasta, "-w",
                str(w), "--device", "cpu", "--num-processes", str(n_proc),
                "--process-id", str(pid), "--coordinator",
                f"localhost:{port}", *extra]
        if devices[pid]:
            argv += ["--devices", str(devices[pid])]
        if pid == 0:
            argv += ["-o", out0]
        return subprocess.Popen(argv, env=env, cwd=REPO,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    for attempt in range(2):
        port = _free_port()
        procs = [launch(pid, port) for pid in range(n_proc)]
        results = []
        try:
            for p in procs:
                out, err = p.communicate(timeout=timeout)
                results.append((p.returncode, out, err))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        if all(rc == 0 for rc, _, _ in results):
            return results
        bind_failed = any(m in err for _, _, err in results
                          for m in BIND_FAILURES)
        if attempt == 1 or not bind_failed:
            raise AssertionError("\n".join(
                f"process {i} rc={rc}\n{err[-2000:]}"
                for i, (rc, _, err) in enumerate(results)))


def _assert_workers_silent(results):
    for rc, out, _err in results[1:]:
        assert rc == 0 and out == ""


def test_two_process_byte_identical(tmp_path):
    """2 processes x 2 local shards (the reference test's "2 virtual
    devices per process"): golden bytes."""
    out0 = str(tmp_path / "out0.meme")
    results = _run_multihost(2, MAFK100, 8, out0, devices=[2, 2])
    assert _read(out0) == _read(os.path.join(GOLDEN_DIR, "mafk100_w8.meme"))
    _assert_workers_silent(results)
    assert sorted(os.listdir(tmp_path)) == ["out0.meme"]


def test_four_process_byte_identical(tmp_path):
    """4 processes x 1 shard: a process count where the shard remainders
    differ from the 2-process case."""
    out0 = str(tmp_path / "out0.meme")
    results = _run_multihost(4, MAFK100, 6, out0)
    assert _read(out0) == _read(os.path.join(GOLDEN_DIR, "mafk100_w6.meme"))
    _assert_workers_silent(results)
    # every rank reports the block it counted and its kernel launches
    # (none on the CPU); the blocks tile the chunk axis in rank order
    edges = []
    for rank, (_rc, _out, err) in enumerate(results):
        m = re.search(rf"rank {rank} of 4 counted chunk rows \[(\d+), (\d+)\)"
                      r" on 1 x cpu, histogram launches 0 \(shared 0, l2 0\),"
                      r" backend gloo", err)
        assert m, err[-2000:]
        edges.append((int(m.group(1)), int(m.group(2))))
    assert edges[0][0] == 0
    assert all(a[1] == b[0] and a[1] > a[0] for a, b in zip(edges, edges[1:]))


def test_uneven_local_meshes_device_engine(tmp_path):
    """Processes with local meshes of 1 and 3 shards (the suspicion
    gather pads its blocks), process 0 on the device engine, which takes
    the summed table as ``precomputed``: within the ENGINE_CASES
    tolerance of golden."""
    out0 = str(tmp_path / "out0.meme")
    _run_multihost(2, os.path.join(GOLDEN_DIR, "synthetic_n.fasta"), 8, out0,
                   devices=[1, 3], extra=["--engine", "tpu"])
    _assert_within_tol(_read(out0), _read(
        os.path.join(GOLDEN_DIR, "synth_w8.meme")), "synth_w8", 5e-6)


def test_multihost_count_past_u16(tmp_path):
    """A single canonical pattern (poly-A at w8) crossing 65,535 counts —
    the reference's int32 refetch case; the port's tables are int32
    throughout.  Output equals the single-process run byte for byte."""
    fasta = str(tmp_path / "polya.fasta")
    with open(fasta, "w") as f:
        for i in range(300):
            f.write(f">s{i}\n{'A' * 2000}\n")
    out1 = str(tmp_path / "single.meme")
    r = subprocess.run(
        [sys.executable, "-m", "peng_motif_tpu_torch", fasta, "-w", "8",
         "--device", "cpu", "-o", out1], env=dict(os.environ, PYTHONPATH=REPO),
        cwd=REPO, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    out0 = str(tmp_path / "out0.meme")
    _run_multihost(2, fasta, 8, out0, devices=[2, 2])
    assert _read(out0) == _read(out1)


def test_missing_process_fails_clean(tmp_path):
    """If a peer never starts, the surviving process must exit with an
    error inside the init timeout instead of hanging forever."""
    env = dict(os.environ, PYTHONPATH=REPO, PENG_MULTIHOST_TIMEOUT="10")
    t0 = time.time()
    p = subprocess.Popen(
        [sys.executable, "-m", "peng_motif_tpu_torch", MAFK100, "-w", "8",
         "--device", "cpu", "--num-processes", "2", "--process-id", "0",
         "--coordinator", f"localhost:{_free_port()}",
         "-o", str(tmp_path / "o.meme")],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        p.communicate(timeout=120)
    except subprocess.TimeoutExpired:
        p.kill()
        p.communicate()
        raise AssertionError("lone multi-process run hung past its timeout")
    assert p.returncode != 0
    assert time.time() - t0 < 120
    assert not (tmp_path / "o.meme").exists()


@pytest.mark.parametrize("name", ["MafK_100seqs.fasta", "synthetic_n.fasta",
                                  "default_sequence_set.fa"])
def test_partial_parse_matches_full(name):
    """read_fasta_lengths / read_fasta_ranges agree with the full parse,
    and with the reference package's, on every quirk file (worker
    processes derive the global layout from them)."""
    path = os.path.join(GOLDEN_DIR, name)
    full = tfasta.read_fasta(path, warn_stream=io.StringIO())
    lengths = tfasta.read_fasta_lengths(path)
    np.testing.assert_array_equal(lengths, [len(s) for s in full.sequences])
    np.testing.assert_array_equal(lengths, jfasta.read_fasta_lengths(path))
    n = len(full.sequences)
    spans = [(0, min(2, n)), (n - 1, n)]
    decoded = tfasta.read_fasta_ranges(path, spans)
    want = jfasta.read_fasta_ranges(path, spans)
    assert sorted(decoded) == sorted(want)
    for i, codes in decoded.items():
        np.testing.assert_array_equal(codes, full.sequences[i])
        np.testing.assert_array_equal(codes, want[i])


def test_choose_backend_from_facts():
    assert mh.choose_backend("cpu", [[], []]) == "gloo"
    assert mh.choose_backend("cuda", [["GPU-a"], ["GPU-b"]]) == "nccl"
    assert mh.choose_backend("cuda", [["GPU-a", "GPU-b"]]) == "nccl"
    # two processes on one card: NCCL refuses two ranks on one GPU
    assert mh.choose_backend("cuda", [["GPU-a"], ["GPU-a"]]) == "gloo"
    assert mh.choose_backend("cuda", [["GPU-a", "GPU-b"],
                                      ["GPU-b", "GPU-c"]]) == "gloo"


def test_local_block_follows_the_processes_mesh_sizes():
    def ctx(rank, shards):
        return mh.MultihostContext(rank, len(shards), (), shards, "gloo",
                                   None, torch.device("cpu"))

    assert mh._local_block(ctx(0, (2, 2)), 100) == (0, 200)
    assert mh._local_block(ctx(1, (2, 2)), 100) == (200, 400)
    assert mh._local_block(ctx(1, (1, 3, 2)), 10) == (10, 40)
    assert mh._local_block(ctx(2, (1, 3, 2)), 10) == (40, 60)


@pytest.mark.parametrize("both", [True, False], ids=["both", "plus"])
def test_world_of_one_in_process(both):
    """init_multihost + the two counts in this process (world size 1,
    gloo, a local mesh of 3 shards) against the reference package's
    stream count and the native background scan; the worker's path
    (lengths + range decodes) builds the same rows."""
    ss = tfasta.load_sequence_set(os.path.join(GOLDEN_DIR,
                                               "synthetic_n.fasta"))
    W = 8
    ctx = mh.init_multihost(f"localhost:{_free_port()}", 1, 0, timeout_s=60,
                            device="cpu", mesh=make_data_mesh(3, "cpu"))
    try:
        assert mh.LAST_BACKEND == ctx.backend == "gloo"
        assert ctx.shards == (3,) and ctx.group is None
        counts, ltot = mh.multihost_stream_counts(
            ctx, ss.sequences, W, both,
            flat_codes=getattr(ss, "_flat_codes", None))
        none, worker_ltot = mh.multihost_stream_counts(
            ctx, None, W, both, input_path=ss.filepath,
            lengths=tfasta.read_fasta_lengths(ss.filepath))
        bg = mh.multihost_bg_counts(ctx, ss.sequences, 2)
        bg_worker = mh.multihost_bg_counts(
            ctx, None, 2, input_path=ss.filepath, n_total=ss.n)
    finally:
        mh.shutdown_multihost()
    want, want_ltot = jsc.StreamCountJob(ss.sequences, W, both).finish()
    assert counts.dtype == np.int32
    np.testing.assert_array_equal(counts, want)
    assert ltot == want_ltot
    assert none is None and isinstance(worker_ltot, int)
    for got in (bg, bg_worker):
        for g, w in zip(got, tbg.count_kmers(ss.sequences, 2)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n_cards,n_procs,want", [
    (4, 4, ["0", "1", "2", "3"]), (4, 2, ["0,1", "2,3"]), (4, 1, ["0,1,2,3"]),
    (2, 2, ["0", "1"]), (8, 4, ["0,1", "2,3", "4,5", "6,7"])])
def test_launcher_card_sets_give_each_process_its_own_cards(n_cards, n_procs,
                                                            want):
    """What a launcher sets as CUDA_VISIBLE_DEVICES per process: distinct
    card sets, so choose_backend answers nccl for the processes' stated
    UUIDs; without it every process sees every card and the cards are
    shared (gloo)."""
    uuids = [f"GPU-{c:02d}" for c in range(n_cards)]
    sets = mh.card_sets(n_cards, n_procs)
    assert sets == want
    seen = [[uuids[int(c)] for c in s.split(",")] for s in sets]
    assert mh.choose_backend("cuda", seen) == "nccl"
    if n_procs > 1:
        assert mh.choose_backend("cuda", [uuids] * n_procs) == "gloo"


@pytest.mark.parametrize("n_cards,n_procs", [(2, 4), (4, 0), (0, 1)])
def test_launcher_card_sets_refuse_too_many_processes(n_cards, n_procs):
    with pytest.raises(ValueError):
        mh.card_sets(n_cards, n_procs)
