"""Programmatic entry points of the port.

Counterpart of the reference repository's ``__graft_entry__.py``.
:func:`entry` exposes one single-device forward step of the flagship
compute path (count -> background DP -> strand aggregate -> expected
counts -> z-scores over the 4**W pattern table), as ``(fn,
example_args)``; :func:`dryrun_multichip` (parallel/dryrun.py) runs the
complete pipeline over an n-device mesh against the single-device run.

    python -m peng_motif_tpu_torch.graft_entry [cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .ops import bgprobs, counting, encoding, stats
from .parallel.dryrun import dryrun_multichip
from .utils.logging_utils import upload

__all__ = ["dryrun_multichip", "entry"]


def _forward(codes, v0, v1, v2, length: int = 6, device=None):
    """z-scores [4**length] f32 of a [B, L] code batch under an order-2
    background, on ``device`` (the card unless the caller names the CPU).
    Inputs: numpy arrays or tensors.  Nothing between the upload and the
    returned tensor waits for the device."""
    dev = resolve_device("cuda" if device is None else device)
    codes, v0, v1, v2 = (upload(a, dev) for a in (codes, v0, v1, v2))
    counts, ltot = counting.count_patterns_device(codes, length, True)
    bg = bgprobs.bg_prob_table([v0, v1, v2], length, 2)
    bg = bgprobs.aggregate_double_strand(bg)
    expected = stats.expected_counts(encoding.to_flat(bg), ltot)
    return stats.zscores(counts, expected)


def dryrun_mesh_size(where: str) -> int:
    """The mesh :func:`dryrun_multichip` runs over from the command line:
    every card there is on ``cuda`` (as the reference's runs over every
    device it sees), four virtual shards on ``cpu``."""
    return torch.cuda.device_count() if where == "cuda" else 4


def entry():
    """Returns (fn, example_args): ``fn(codes, v0, v1, v2, length=6,
    device=None)``, and the reference entry point's example arguments."""
    rng = np.random.default_rng(0)
    codes = rng.integers(1, 5, size=(8, 64)).astype(np.uint8)
    v0 = np.full(4, 0.25, dtype=np.float32)
    v1 = np.full(16, 0.25, dtype=np.float32)
    v2 = np.full(64, 0.25, dtype=np.float32)
    return _forward, (codes, v0, v1, v2)


if __name__ == "__main__":
    import sys

    where = sys.argv[1] if len(sys.argv) > 1 else "cuda"
    fn, args = entry()
    out = fn(*args, device=where)
    print("entry ok:", tuple(out.shape), out.device)
    n = dryrun_mesh_size(where)
    dryrun_multichip(n, where)
    print(f"dryrun_multichip({n}, {where}) ok")
