"""Logging and per-phase timing.

Upgrades the reference's write-only verbosity flag (reference:
src/Global.cpp:51,146-153 — parsed but never consulted) and plain-cout
status lines (src/peng.cpp:315-320) into a real logger plus a phase
timer that doubles as lightweight profiling.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import time
from typing import Dict, List, Tuple

_LEVELS = {
    0: logging.ERROR,
    1: logging.WARNING,
    2: logging.INFO,
    3: logging.DEBUG,
}

_logger = None


def get_logger() -> logging.Logger:
    global _logger
    if _logger is None:
        _logger = logging.getLogger("peng_motif_tpu_torch")
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("[%(asctime)s] %(levelname)s: %(message)s")
        )
        _logger.addHandler(handler)
        _logger.setLevel(logging.INFO)
    return _logger


def set_verbosity(verbosity: int):
    get_logger().setLevel(_LEVELS.get(min(verbosity, 3), logging.DEBUG))


class PhaseTimer:
    """Wall-clock accounting per pipeline phase."""

    def __init__(self):
        self.records: List[Tuple[str, float]] = []

    @contextlib.contextmanager
    def phase(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.records.append((name, time.perf_counter() - start))

    def totals(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, dt in self.records:
            out[name] = out.get(name, 0.0) + dt
        return out

    def report(self, stream=None):
        # stream resolves at call time so redirect_stderr captures it
        if stream is None:
            stream = sys.stderr
        for name, dt in self.totals().items():
            print(f"[TIMING] {name}: {dt * 1e3:.1f} ms", file=stream)


@contextlib.contextmanager
def torch_profile(trace_dir, device=None):
    """Profile a block with ``torch.profiler`` (``--profile`` CLI flag):
    host activity always, and the card's kernels and copies when
    ``device`` is a CUDA device; writes the Chrome trace
    ``<trace_dir>/trace.json``.  No-op when ``trace_dir`` is None."""
    if trace_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    activities = [ProfilerActivity.CPU]
    if device is not None and device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
