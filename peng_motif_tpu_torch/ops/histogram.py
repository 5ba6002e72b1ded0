"""Exact int32 histogram: the one kernel of the count phase.

Counterpart of ``peng_motif_tpu/ops/pallas_hist.py``: its dispatcher
``histogram`` and the three Pallas kernels behind it are replaced by one
hand-written CUDA kernel for sm_90a (``csrc/histogram.cu``; the note
there says why one kernel serves every table size on Hopper).

Contract (the dispatcher's): ``counts[id] += 1`` for every input whose
``inc`` is non-zero; ``ids`` int32 [N] in [0, n_bins) wherever ``inc``
is set, ``inc`` bool / uint8 / int32 [N], result int32 [n_bins], exact
below 2**31.  Ids of masked inputs are never read.

:func:`histogram` launches the kernel for CUDA tensors and takes the
plain PyTorch version, :func:`histogram_plain`, only for tensors on the
CPU.  The kernel library is built with nvcc at the first CUDA call (and
again when the source is newer); a missing nvcc or a failed build
raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

import torch

from ..native import BUILD_DIR, compile_library

_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "histogram.cu")
_SO = os.path.join(BUILD_DIR, "libpeng_kernels.so")

# kernel launches made by :func:`histogram` (one per launch, nowhere
# else): a run reads it to show the main path went through the kernel
LAUNCHES = 0

_lock = threading.Lock()
_lib = None
BUILD_LOG = ""


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
    """Build (if stale) and load the kernel library; raises on failure.
    ``BUILD_LOG`` keeps the compiler's report (registers, shared memory,
    spills from ``-Xptxas -v``) of the build this process ran."""
    global _lib, BUILD_LOG
    with _lock:
        if _lib is None:
            log = compile_library(_SRC, _SO, [
                _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-Xptxas", "-v"])
            BUILD_LOG = log or BUILD_LOG
            lib = ctypes.CDLL(_SO)
            lib.peng_histogram.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p]
            lib.peng_histogram.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check(ids: torch.Tensor, inc: torch.Tensor, n_bins: int) -> None:
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


def histogram_plain(ids: torch.Tensor, inc: torch.Tensor,
                    n_bins: int) -> torch.Tensor:
    """The plain PyTorch version: bincount of the counted ids."""
    counts = torch.bincount(ids[inc != 0], minlength=n_bins)
    if counts.shape[0] != n_bins:
        raise ValueError(f"histogram: a counted id is >= n_bins ({n_bins})")
    return counts.to(torch.int32)


def histogram(ids: torch.Tensor, inc: torch.Tensor,
              n_bins: int) -> torch.Tensor:
    """int32 [n_bins] counts of the ids whose ``inc`` is non-zero: the
    CUDA kernel for CUDA tensors, :func:`histogram_plain` for CPU ones."""
    global LAUNCHES
    _check(ids, inc, n_bins)
    if ids.device.type == "cpu":
        return histogram_plain(ids, inc, n_bins)
    if ids.device.type != "cuda":
        raise ValueError(f"histogram: unsupported device {ids.device}")
    if inc.dtype == torch.int32:
        inc = inc != 0
    if inc.dtype == torch.bool:
        inc = inc.view(torch.uint8)
    out = torch.zeros(n_bins, dtype=torch.int32, device=ids.device)
    if ids.numel() == 0:
        return out
    lib = build_kernels()
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream(ids.device).cuda_stream
        err = lib.peng_histogram(ids.data_ptr(), inc.data_ptr(), ids.numel(),
                                 out.data_ptr(), n_bins, stream)
    if err != 0:
        raise RuntimeError(f"histogram kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
