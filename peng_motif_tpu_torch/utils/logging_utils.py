"""Logging, and the port's one span and counter recorder.

Upgrades the reference's write-only verbosity flag (reference:
src/Global.cpp:51,146-153 — parsed but never consulted) and plain-cout
status lines (src/peng.cpp:315-320) into a real logger plus a recorder
of spans and counters.

:class:`PhaseTimer` is the recorder, one per job: ``cli.main`` creates it
before it parses an argument and activates it (:meth:`PhaseTimer.activate`)
for the whole job, so code below the CLI records into it through the
module functions :func:`span`, :func:`count`, :func:`start_thread`,
:func:`sync_read` and :func:`upload` without being handed it.  A span is a
name, a start and an end (``time.perf_counter_ns``), the span that was
open on the same thread when it began (or, on a worker thread, the span
that started the thread) and its thread; its printed name is its path,
the parents' names joined by ``.``.  Spans stay in memory: ``--timing``
prints their totals at the end of the job (:meth:`PhaseTimer.report`),
``--profile`` writes them into the trace (:func:`torch_profile`).

Recording is always on and costs two clock reads and an append a span.
It adds no device synchronisation and no copy: a span around device work
measures the host's enqueue of it, or its wait for it, and its name says
which.  While torch's profiler runs, each span of the job's own thread
also opens a ``torch.profiler.record_function`` range of its path, so it
lies on the device trace's clock; the spans of worker threads are added
to the trace at export, placed by an anchor range.

Counters count at the place the work happens: ``syncs`` (each point
where the host waits for the device's stream: every blocking read of a
device tensor, through :func:`sync_read`, and every upload, since a
pageable host-to-device copy drains the stream), ``h2d.copies`` and
``h2d.bytes`` (every host-to-device copy, through :func:`upload`).  Work
counts are the calls of a span (``optimize.step``: the climb's lockstep
steps; ``pwm.em_round``: EM's rounds).
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import logging
import os
import sys
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

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


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------


COUNTERS = ("syncs", "h2d.copies", "h2d.bytes")   # always reported


class Span(NamedTuple):
    """One finished span."""

    path: str       # the parents' names and its own, joined by "."
    start_ns: int   # time.perf_counter_ns()
    end_ns: int
    id: int
    parent: int     # the parent's id, -1 for a top-level span
    thread: int     # threading.get_native_id() of its thread
    traced: bool    # it opened a profiler range of its own


_now = time.perf_counter_ns


class _SpanContext:
    """``with recorder.span(name):`` — two clock reads and an append.
    While open it is the handle its children and threads name as their
    parent (``path``, ``id``)."""

    __slots__ = ("_rec", "_name", "_parent", "path", "id", "_up", "_start",
                 "_range")

    def __init__(self, rec: "PhaseTimer", name: str,
                 parent: Optional["_SpanContext"]):
        self._rec, self._name, self._parent = rec, name, parent

    def __enter__(self):
        rec = self._rec
        stack = rec._stack()
        parent = self._parent or (stack[-1] if stack else None)
        self.id = next(rec._ids)
        if parent is None:
            self.path, self._up = self._name, -1
        else:
            self.path, self._up = f"{parent.path}.{self._name}", parent.id
        stack.append(self)
        self._range = None
        if (_autograd_profiler._is_profiler_enabled
                and threading.get_ident() == rec._home):
            self._range = _autograd_profiler.record_function(self.path)
            self._range.__enter__()
        self._start = _now()
        return self

    def __exit__(self, *exc):
        end = _now()
        if self._range is not None:
            self._range.__exit__(*exc)
        local = self._rec._local
        local.stack.pop()
        self._rec._raw.append((self.path, self._start, end, self.id,
                               self._up, local.tid, self._range is not None))
        return False


_active: contextvars.ContextVar = contextvars.ContextVar(
    "peng_motif_tpu_torch_recorder", default=None)


class PhaseTimer:
    """The job's spans and counters (module docstring).  The four phases
    of both engines (count, optimize, pwm, em+merge) enter through
    :meth:`phase`, every other span through :meth:`span`."""

    def __init__(self):
        self._raw: List[tuple] = []       # finished spans, Span's fields
        self.counters: Dict[str, int] = {}
        self._ids = itertools.count()
        self._local = threading.local()   # per thread: open spans, tid
        self._lock = threading.Lock()
        self._home = threading.get_ident()   # the job's own thread

    @property
    def spans(self) -> List[Span]:
        return [Span._make(t) for t in self._raw]

    def _stack(self) -> list:
        local = self._local
        try:
            return local.stack
        except AttributeError:
            local.stack, local.tid = [], threading.get_native_id()
            return local.stack

    def phase(self, name: str):
        """One of the four phases: a top-level span."""
        return self.span(name)

    def span(self, name: str, parent: Optional[_SpanContext] = None):
        """A span named ``name`` under the span open on this thread, or
        under ``parent`` (an open span of another thread)."""
        return _SpanContext(self, name, parent)

    def innermost(self) -> Optional[_SpanContext]:
        """The span open on this thread, innermost first; None if none."""
        stack = self._stack()
        return stack[-1] if stack else None

    def add(self, path: str, start_ns: int, end_ns: int):
        """A top-level span timed by the caller (set-up before the job)."""
        self._raw.append((path, start_ns, end_ns, next(self._ids), -1,
                          threading.get_native_id(), False))

    def count(self, name: str, n: int = 1):
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    @contextlib.contextmanager
    def activate(self):
        """Make this the recorder of the module functions for the block."""
        token = _active.set(self)
        try:
            yield self
        finally:
            _active.reset(token)

    def totals(self) -> Dict[str, Tuple[float, int]]:
        """{path: (seconds, calls)}, in the order the paths first began."""
        out: Dict[str, list] = {}
        for path, start, end, *_ in sorted(self._raw, key=lambda t: t[1]):
            tot = out.setdefault(path, [0, 0])
            tot[0] += end - start
            tot[1] += 1
        return {p: (ns / 1e9, n) for p, (ns, n) in out.items()}

    def calls(self, path: str) -> int:
        return sum(1 for t in self._raw if t[0] == path)

    def report(self, stream=None):
        """``[TIMING] <path>: <ms> ms (<calls>)`` for every span path,
        then ``[COUNT] <name>: <n>`` for every counter."""
        # stream resolves at call time so redirect_stderr captures it
        if stream is None:
            stream = sys.stderr
        lines = [f"[TIMING] {path}: {sec * 1e3:.3f} ms ({n})"
                 for path, (sec, n) in self.totals().items()]
        counters = dict.fromkeys(COUNTERS, 0)
        counters.update(self.counters)
        lines += [f"[COUNT] {name}: {n}" for name, n in counters.items()]
        print("\n".join(lines), file=stream)

    def trace_events(self, anchor_ns: int, anchor_us: float,
                     pid: int) -> List[dict]:
        """Chrome-trace events of the spans that opened no profiler range
        (worker threads', and those begun before the profiler), on the
        trace's clock: ``anchor_ns`` on this clock is ``anchor_us`` on
        the trace's."""
        return [dict(ph="X", cat="user_annotation", name=s.path, pid=pid,
                     tid=s.thread,
                     ts=anchor_us + (s.start_ns - anchor_ns) / 1e3,
                     dur=(s.end_ns - s.start_ns) / 1e3)
                for s in self.spans if not s.traced]


def span(name: str):
    """A span of the running job's recorder; nothing outside a job."""
    rec = _active.get()
    return contextlib.nullcontext() if rec is None else rec.span(name)


def count(name: str, n: int = 1):
    rec = _active.get()
    if rec is not None:
        rec.count(name, n)


def start_thread(name: str, target) -> threading.Thread:
    """Start ``target`` on a daemon thread, recorded as the span ``name``
    under the span open here; the thread counts into this job's
    recorder too."""
    rec = _active.get()
    parent = rec.innermost() if rec is not None else None

    def run():
        if rec is None:
            target()
            return
        with rec.span(name, parent=parent):
            target()

    t = threading.Thread(target=contextvars.copy_context().run, args=(run,),
                         daemon=True)
    t.start()
    return t


def sync_read(t: torch.Tensor, read=None):
    """Every blocking read of a device tensor by the host goes through
    here: ``read(t)`` (``t.cpu()`` by default; ``int``, ``bool``,
    ``torch.nonzero``, ``torch.Tensor.tolist``), counted in ``syncs``
    when ``t`` is on a device (the copy of an empty tensor is none)."""
    if t.device.type != "cpu" and (read is not None or t.numel()):
        count("syncs")
    return t.cpu() if read is None else read(t)


def upload(x, device, dtype=None) -> torch.Tensor:
    """Every host-to-device copy goes through here: ``x`` (a numpy
    array, a host tensor or a Python scalar) as a tensor on ``device``,
    in ``dtype`` if given (converted on the host, as torch's blocking
    copy does), counted in ``h2d.copies``, ``h2d.bytes`` and ``syncs``
    when ``device`` is not the host and ``x`` is not empty.  A tensor
    already on a device is moved there by torch, and counted as
    nothing."""
    t = torch.as_tensor(x)
    out = t.to(device=device, dtype=dtype)
    if t.device.type == "cpu" and out.device.type != "cpu" and out.numel():
        count("h2d.copies")
        count("h2d.bytes", out.numel() * out.element_size())
        count("syncs")
    return out


# ---------------------------------------------------------------------------
# cold start: what a process pays before its first job's spans
# ---------------------------------------------------------------------------

_IMPORTED_NS: Optional[int] = None
_COLD = True


def mark_imported():
    """The end of the package's import (called once, by the CLI)."""
    global _IMPORTED_NS
    if _IMPORTED_NS is None:
        _IMPORTED_NS = time.perf_counter_ns()


def process_start_ns() -> Optional[int]:
    """This process's start on the perf_counter_ns clock (Linux
    ``/proc/self/stat``, clock-tick resolution); None elsewhere."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return None
    age_s = uptime - ticks / os.sysconf("SC_CLK_TCK")
    return time.perf_counter_ns() - int(age_s * 1e9)


def take_cold_start(recorder: PhaseTimer) -> bool:
    """True for the process's first job only, whose report holds the
    cold start: the span ``setup.import`` (process start to the end of
    the package's import) goes into ``recorder`` here, the caller's
    ``device`` span and the libraries' first load (``lib.native``,
    ``lib.histogram``) where they happen."""
    global _COLD
    first, _COLD = _COLD, False
    start = process_start_ns() if first else None
    if start is not None and _IMPORTED_NS is not None:
        recorder.add("setup.import", start, _IMPORTED_NS)
    return first


# ---------------------------------------------------------------------------
# --profile
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def torch_profile(trace_dir, device: str = "cpu", recorder=None):
    """Profile a block with ``torch.profiler`` (``--profile`` CLI flag):
    host activity always, and the card's kernels and copies when
    ``device`` is ``cuda``; writes the Chrome trace
    ``<trace_dir>/trace.json`` with ``recorder``'s spans that opened no
    profiler range of their own added to it.  No-op when ``trace_dir``
    is None."""
    if trace_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    activities = [ProfilerActivity.CPU]
    if device == "cuda" and torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        # the anchor: a range whose start is read on both clocks
        t0 = time.perf_counter_ns()
        with _autograd_profiler.record_function(_ANCHOR):
            t1 = time.perf_counter_ns()
        yield
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    if recorder is None:
        return
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    anchor = next(e for e in events if e.get("name") == _ANCHOR
                  and e.get("ph") == "X")
    events += recorder.trace_events((t0 + t1) // 2, float(anchor["ts"]),
                                    anchor.get("pid", os.getpid()))
    with open(path, "w") as f:
        json.dump(trace, f)


_ANCHOR = "peng_motif_tpu_torch.clock"
