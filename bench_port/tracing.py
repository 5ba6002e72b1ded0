"""A few whole jobs under torch.profiler, and what the per-layer metrics
read from them: the device's busy time (the union of its kernel, copy
and fill spans), the traced window, the histogram kernels' time and the
inputs their calls were given, and the breakdown (the device operations
that took most time; the device's idle gaps by what the host was doing).

Spans are recorded from the benchmark's side only: each ``--timing``
phase of the program (``PhaseTimer.phase``) is wrapped in a profiler
range for the traced jobs, and the stream count's histogram calls are
recorded at their call boundary (``ops.stream_count.histogram``).
"""

from __future__ import annotations

import contextlib
import json
import os
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HIST_KERNELS = ("hist_shared_kernel", "hist_l2_kernel")
NAME_CHARS = 160   # a kernel's name in the breakdown, cut to this length


def merged(spans):
    """The union of (start, end) spans as disjoint sorted intervals."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union(spans):
    """Length covered by the union of (start, end) spans."""
    return sum(e - s for s, e in merged(spans))


@contextlib.contextmanager
def _annotated():
    """Profiler ranges named ``phase:<name>`` around the program's timed
    phases, and a record of the stream count's histogram calls."""
    import torch
    from peng_motif_tpu_torch.ops import stream_count
    from peng_motif_tpu_torch.utils.logging_utils import PhaseTimer

    calls = []
    real_phase, real_hist = PhaseTimer.phase, stream_count.histogram

    @contextlib.contextmanager
    def phase(self, name):
        with torch.profiler.record_function(f"phase:{name}"), \
                real_phase(self, name):
            yield

    def histogram(ids, inc, n_bins, out=None):
        if ids.is_cuda and ids.numel():
            calls.append((ids.numel(), n_bins))
        return real_hist(ids, inc, n_bins, out=out)

    PhaseTimer.phase, stream_count.histogram = phase, histogram
    try:
        yield calls
    finally:
        PhaseTimer.phase, stream_count.histogram = real_phase, real_hist


def _gap_names(gaps, host):
    """What the host was doing in each gap: the program's phase and the
    innermost host range (the latest-starting one) that covers the gap's
    middle.  One sweep over the gaps in order, with a heap of the host
    ranges begun so far; a range that has ended is dropped for good,
    since the middles only grow."""
    import heapq

    host = sorted(host, key=lambda h: h[1])
    heaps = {True: [], False: []}          # is a phase range -> heap
    names = {}
    k = 0
    for g in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (g[0] + g[1]) / 2
        while k < len(host) and host[k][1] <= mid:
            name, start, end = host[k]
            heapq.heappush(heaps[name.startswith("phase:")],
                           (-start, end, name))
            k += 1
        top = {}
        for is_phase, heap in heaps.items():
            while heap and heap[0][1] < mid:
                heapq.heappop(heap)
            top[is_phase] = heap[0][2] if heap else None
        phase = top[True][6:] if top[True] else "cli"
        names[g] = f"{phase}/{top[False] or 'host'}"
    return [names[g] for g in gaps]


def reduce(events, window_name="bench_port.traced_jobs"):
    """busy_s, window_s, breakdown and the histogram kernels' time from
    a Chrome trace's events."""
    win = [e for e in events if e.get("name") == window_name
           and e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    if not win:
        raise RuntimeError("the trace holds no window range")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    dev, by_name, host = [], defaultdict(float), []
    hist_us = 0.0
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, t = e["ts"], e["ts"] + e["dur"]
        if e.get("cat") in DEVICE_CATS:
            s, t = max(s, w0), min(t, w1)
            if t <= s:
                continue
            dev.append((s, t))
            by_name[e["name"][:NAME_CHARS]] += (t - s) / 1e6
            if any(k in e["name"] for k in HIST_KERNELS):
                hist_us += t - s
        elif e.get("cat") in ("cpu_op", "user_annotation", "python_function"):
            if e["name"] != window_name:
                host.append((e["name"], s, t))
    busy = merged(dev)
    gaps = [(a[1], b[0]) for a, b in zip([[w0, w0]] + busy, busy + [[w1, w1]])
            if b[0] > a[1]]
    idle = defaultdict(float)
    for g, name in zip(gaps, _gap_names(gaps, host)):
        idle[name] += (g[1] - g[0]) / 1e6
    top = lambda d: sorted(([k, v] for k, v in d.items()),  # noqa: E731
                           key=lambda kv: -kv[1])[:10]
    return dict(busy_s=union(dev) / 1e6, window_s=(w1 - w0) / 1e6,
                hist_s=hist_us / 1e6,
                breakdown=dict(device_ops=top(by_name), idle_gaps=top(idle)))


def traced_jobs(run_one, n: int, workdir: str, device: str) -> dict:
    """``run_one(k)`` for k < n under the profiler; returns the jobs, the
    histogram calls they made and :func:`reduce` of the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.startswith("cuda"):
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    path = os.path.join(workdir, "trace.json")
    with _annotated() as calls, profile(activities=acts) as prof:
        with record_function("bench_port.traced_jobs"):
            jobs = [run_one(k) for k in range(n)]
            if device.startswith("cuda"):
                torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    out = reduce(events)
    out.update(jobs=jobs, hist_calls=calls)
    return out
