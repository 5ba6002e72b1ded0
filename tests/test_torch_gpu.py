"""Card-only tests of the port: the CUDA histogram kernel against its
plain PyTorch version, the stream count on the card against the same
count on the CPU, and the CLI through the kernel.  Every test skips
without a CUDA device.

This file imports neither jax nor the reference package, so that it runs
on a machine without them:

    python -m pytest --noconftest tests/test_torch_gpu.py -q

Tolerance: bit-identical (integer counts); MEME output byte-identical to
the golden files (phases 2-5 run on the byte-exact host twins).
"""

import os

import numpy as np
import pytest
import torch

from peng_motif_tpu_torch import engine
from peng_motif_tpu_torch.cli import main
from peng_motif_tpu_torch.ops import histogram as th
from peng_motif_tpu_torch.ops import stream_count as tsc

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "golden")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the histogram kernel runs only "
                    "on the card")
    return torch.device("cuda")


def _inputs(n, n_bins, seed, frac=0.8):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_bins, size=n).astype(np.int32),
            rng.random(n) < frac)


@pytest.mark.parametrize("n_bins", [384, 4 ** 6, 4 ** 7, 4 ** 8, 4 ** 10,
                                    4 ** 12])
def test_kernel_matches_plain(n_bins, cuda):
    ids, inc = _inputs(2_000_000, n_bins, seed=7)
    ids_d = torch.from_numpy(ids).to(cuda)
    inc_d = torch.from_numpy(inc).to(cuda)
    before = th.LAUNCHES
    got = th.histogram(ids_d, inc_d, n_bins)
    torch.cuda.synchronize()
    assert th.LAUNCHES == before + 1
    assert torch.equal(got, th.histogram_plain(ids_d, inc_d, n_bins))
    assert torch.equal(got.cpu(), th.histogram(torch.from_numpy(ids),
                                               torch.from_numpy(inc), n_bins))


@pytest.mark.parametrize("edge", ["empty", "all_masked", "one_hot_bin",
                                  "last_bin"])
@pytest.mark.parametrize("inc_dtype", [torch.bool, torch.uint8, torch.int32])
def test_kernel_edge_inputs(edge, inc_dtype, cuda):
    for n_bins in (384, 4 ** 9):
        ids, inc = _inputs(3000, n_bins, seed=1)
        if edge == "empty":
            ids, inc = ids[:0], inc[:0]
        elif edge == "all_masked":
            inc[:] = False
        elif edge == "one_hot_bin":
            ids[:] = n_bins // 3
        else:
            ids[::5] = n_bins - 1
        ids_d = torch.from_numpy(ids).to(cuda)
        inc_d = torch.from_numpy(inc).to(cuda, inc_dtype)
        got = th.histogram(ids_d, inc_d, n_bins)
        torch.cuda.synchronize()
        assert torch.equal(got, th.histogram_plain(ids_d, inc_d, n_bins))


def test_kernel_rejects_mixed_devices(cuda):
    with pytest.raises(ValueError):
        th.histogram(torch.zeros(4, dtype=torch.int32, device=cuda),
                     torch.ones(4, dtype=torch.bool), 8)


@pytest.mark.parametrize("wire2", [False, True], ids=["mask", "wire2"])
def test_stream_count_on_card_matches_cpu(wire2, cuda):
    rng = np.random.default_rng(5)
    W = 8
    if wire2:
        seqs = [rng.integers(1, 5, size=400).astype(np.uint8)
                for _ in range(300)]
    else:
        seqs = [rng.integers(0, 5, size=int(n)).astype(np.uint8)
                for n in rng.integers(3, 3000, size=200)]
    stream, lay = tsc.build_stream(seqs, W)
    pack = tsc.chunked_packed2 if wire2 else tsc.chunked_packed
    buf_np = pack(stream, lay)
    outs = {}
    for dev in ("cpu", cuda):
        buf, meta = tsc.from_reference_buffer(buf_np, lay, wire2, dev)
        if wire2:
            out = tsc.stream_count_device_fused2(buf, meta, lay.row,
                                                 lay.ctx, W, True, 2)
        else:
            out = tsc.stream_count_device_fused(buf, lay.row, lay.ctx, W,
                                                True, 2)
        outs[str(dev)] = [t.cpu() for t in out]
    for a, b in zip(outs["cpu"], outs[str(cuda)]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("stem,args", [
    ("mafk100_w8", ["MafK_100seqs.fasta", "-w", "8"]),
    ("mafk_w8", ["MafK.fasta", "-w", "8"]),
    ("mafk_w10", ["MafK.fasta", "-w", "10"]),
    ("synth_w8", ["synthetic_n.fasta", "-w", "8"]),
    ("synth_w8_plus", ["synthetic_n.fasta", "-w", "8", "--strand", "PLUS"])])
def test_cli_golden_through_kernel(stem, args, cuda, tmp_path):
    th.LAUNCHES = 0
    meme = tmp_path / "o.meme"
    assert main([os.path.join(GOLDEN_DIR, args[0])] + args[1:]
                + ["--device", "cuda", "-o", str(meme)]) == 0
    assert engine.LAST_ENGINE_USED == "gpu"
    assert th.LAUNCHES > 0
    with open(os.path.join(GOLDEN_DIR, f"{stem}.meme")) as g:
        assert meme.read_text() == g.read()
