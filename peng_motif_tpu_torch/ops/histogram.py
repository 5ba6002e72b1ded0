"""Exact int32 histogram: the one kernel family of the count phase.

Counterpart of ``peng_motif_tpu/ops/pallas_hist.py``: its dispatcher
``histogram`` and the three Pallas kernels behind it are replaced by
hand-written CUDA kernels for sm_90a (``csrc/histogram.cu``; the note
there says what bounds each tier on the card and what the design does
about it).

Contract (the dispatcher's): ``counts[id] += 1`` for every input whose
``inc`` is non-zero; ``ids`` int32 [N], ``inc`` bool / uint8 / int32 [N]
(any non-zero value counts), result int32 [n_bins], exact below 2**31.
Ids of masked inputs may be anything: they are never compared or used as
an address.  With ``out`` given (int32 [n_bins], contiguous, on the
inputs' device) the counts are added into it and nothing is allocated.

:func:`histogram` launches the kernels for CUDA tensors and takes the
plain PyTorch version, :func:`histogram_plain`, only for tensors on the
CPU.  :func:`plan` is the dispatcher: from ``n_bins`` and ``N`` alone it
chooses the tier (sub-histograms in shared memory, or reductions in L2)
and the bin ranges, one launch each.  The kernel library (this kernel and
EM's round, ``csrc/em.cu``, in one nvcc call) is built at the first CUDA
call (and again when a source is newer); a missing nvcc, a failed build
or a refused launch raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import threading
from typing import NamedTuple, Optional, Tuple

import torch

from ..native import BUILD_DIR, compile_library
from ..utils.logging_utils import span

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
_SRCS = tuple(os.path.join(_CSRC, name)
              for name in ("histogram.cu", "em.cu"))
_SO = os.path.join(BUILD_DIR, "libpeng_kernels.so")

# kernel launches made by :func:`histogram` (one per launch, nowhere
# else), in all, per tier (each tier is one kernel) and per card (by
# device index): a run reads them to show the main path went through the
# kernels, on every card of a mesh
LAUNCHES = 0
TIER_LAUNCHES = {"shared": 0, "l2": 0}
DEVICE_LAUNCHES: dict = {}

_lock = threading.Lock()
_lib = None
BUILD_LOG = ""

# the most shared memory one block may have on sm_90 (static + dynamic)
SHARED_BYTES = 232_448
SHARED_MAX_BINS = SHARED_BYTES // 4
# a table of up to this many times the shared limit still goes to the
# shared tier, cut into slices whose blocks each read the whole input
# (4**8: two slices of 128 KB; 4**9: five of 205 KB).  Every slice costs
# one more read of the input, from L2; at 4**10 (19 slices) that costs
# more than one L2 atomic per input does
SHARED_MAX_SLICES = 5
# the most of a table that one L2-tier launch adds into.  The card's L2
# is 50 MB and the input streams through it beside the table; a larger
# table (4**12: 64 MB) is counted in equal bin-range passes of at most
# this size, the input read once each.  Measured at 4**12 (PERF.md):
# three passes of 21.3 MB beat two of 32 MB and four of 16 MB.
L2_TABLE_BYTES = 24 << 20
# an atomic touches one 32-byte sector of the table: an input this short
# cannot touch more of any table than L2 keeps, and takes one pass
L2_SECTOR_BYTES = 32

_TIERS = {"shared": 0, "l2": 1}


class Plan(NamedTuple):
    """What :func:`histogram` launches for one call."""
    tier: str                               # "shared" or "l2"
    slices: int                             # shared: slices of the range
    ranges: Tuple[Tuple[int, int], ...]     # [lo, hi) per launch
    shared_bytes: int                       # dynamic shared memory a block


def _tiles(n_bins: int, k: int) -> Tuple[Tuple[int, int], ...]:
    """[0, n_bins) in ``k`` equal ranges (the last may be shorter)."""
    width = -(-n_bins // k)
    return tuple((lo, min(lo + width, n_bins))
                 for lo in range(0, n_bins, width))


def plan(n_bins: int, n: int) -> Plan:
    """The dispatcher, a pure function of the table size and the input
    length (see the constants above for each threshold)."""
    slices = -(-n_bins // SHARED_MAX_BINS)
    if slices <= SHARED_MAX_SLICES:
        return Plan("shared", slices, ((0, n_bins),),
                    4 * -(-n_bins // slices))
    if L2_SECTOR_BYTES * n <= L2_TABLE_BYTES:
        return Plan("l2", 0, ((0, n_bins),), 0)
    return Plan("l2", 0, _tiles(n_bins, -(-4 * n_bins // L2_TABLE_BYTES)), 0)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the "
            "histogram kernel cannot be built")
    return found


def build_kernels() -> ctypes.CDLL:
    """Build (if stale) and load the kernel library (``peng_histogram``
    and ``peng_em_round``); raises on failure.
    ``BUILD_LOG`` keeps the compiler's report (registers, shared memory,
    spills from ``-Xptxas -v``) of the build this process ran."""
    global _lib, BUILD_LOG
    if _lib is not None:
        return _lib
    with _lock, span("lib.histogram"):
        if _lib is None:
            log = compile_library(_SRCS, _SO, [
                _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-Xptxas", "-v"])
            BUILD_LOG = log or BUILD_LOG
            lib = ctypes.CDLL(_SO)
            lib.peng_histogram.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_void_p]
            lib.peng_histogram.restype = ctypes.c_int
            lib.peng_em_round.argtypes = [ctypes.c_void_p] * 8 + [
                ctypes.c_int32, ctypes.c_int32, ctypes.c_float,
                ctypes.c_float, ctypes.c_int32, ctypes.c_void_p]
            lib.peng_em_round.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check(ids: torch.Tensor, inc: torch.Tensor, n_bins: int,
           out: Optional[torch.Tensor]) -> None:
    if ids.dtype != torch.int32:
        raise TypeError(f"histogram: ids must be int32, got {ids.dtype}")
    if inc.dtype not in (torch.bool, torch.uint8, torch.int32):
        raise TypeError(
            f"histogram: inc must be bool, uint8 or int32, got {inc.dtype}")
    if ids.dim() != 1 or inc.shape != ids.shape:
        raise ValueError(
            "histogram: ids and inc must be 1-D of one length, got "
            f"{tuple(ids.shape)} and {tuple(inc.shape)}")
    if not (ids.is_contiguous() and inc.is_contiguous()):
        raise ValueError("histogram: ids and inc must be contiguous")
    if ids.device != inc.device:
        raise ValueError(
            f"histogram: ids on {ids.device} but inc on {inc.device}")
    if not 0 < n_bins < (1 << 31):
        raise ValueError(f"histogram: n_bins out of range: {n_bins}")
    if out is not None:
        if out.dtype != torch.int32 or tuple(out.shape) != (n_bins,):
            raise TypeError(
                f"histogram: out must be int32 [{n_bins}], got {out.dtype} "
                f"{tuple(out.shape)}")
        if not out.is_contiguous():
            raise ValueError("histogram: out must be contiguous")
        if out.device != ids.device:
            raise ValueError(
                f"histogram: ids on {ids.device} but out on {out.device}")


def histogram_plain(ids: torch.Tensor, inc: torch.Tensor, n_bins: int,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version: bincount of the counted ids that lie
    in [0, n_bins), added into ``out`` when that is given."""
    counted = ids[(inc != 0) & (ids >= 0) & (ids < n_bins)]
    counts = torch.bincount(counted, minlength=n_bins).to(torch.int32)
    if out is None:
        return counts
    out += counts
    return out


def on_device(device: torch.device):
    """The kernels launch on the current device: a context that makes
    ``device`` current, switching only if it differs."""
    if torch.cuda.current_device() == device.index:
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def launch_plan(ids: torch.Tensor, inc: torch.Tensor, n_bins: int,
                out: torch.Tensor, p: Plan) -> None:
    """Add the counts into ``out`` with one kernel launch per bin range
    of ``p``; ``inc`` is uint8 here.  Raises on the first refused launch."""
    global LAUNCHES
    lib = build_kernels()
    with on_device(ids.device):
        stream = torch.cuda.current_stream(ids.device).cuda_stream
        for lo, hi in p.ranges:
            err = lib.peng_histogram(
                ids.data_ptr(), inc.data_ptr(), ids.numel(), out.data_ptr(),
                n_bins, _TIERS[p.tier], p.slices, lo, hi, stream)
            if err != 0:
                raise RuntimeError(
                    f"histogram kernel launch failed: CUDA error {err} "
                    f"(tier {p.tier}, bins [{lo}, {hi}) of {n_bins})")
            LAUNCHES += 1
            TIER_LAUNCHES[p.tier] += 1
            DEVICE_LAUNCHES[ids.device.index] = (
                DEVICE_LAUNCHES.get(ids.device.index, 0) + 1)


def histogram(ids: torch.Tensor, inc: torch.Tensor, n_bins: int,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int32 [n_bins] counts of the ids whose ``inc`` is non-zero (added
    into ``out`` when given): the CUDA kernels for CUDA tensors,
    :func:`histogram_plain` for CPU ones."""
    _check(ids, inc, n_bins, out)
    if ids.device.type == "cpu":
        return histogram_plain(ids, inc, n_bins, out)
    if ids.device.type != "cuda":
        raise ValueError(f"histogram: unsupported device {ids.device}")
    if inc.dtype == torch.int32:
        inc = inc != 0
    if inc.dtype == torch.bool:
        inc = inc.view(torch.uint8)
    if out is None:
        out = torch.zeros(n_bins, dtype=torch.int32, device=ids.device)
    if ids.numel() > 0:
        launch_plan(ids, inc, n_bins, out, plan(n_bins, ids.numel()))
    return out
