"""The traced run's record: the profiler's device activity and host
operations over the window, reduced to plain lists that the per-layer
readers (`metrics/`) read.

Device activity is every profiler event on the CUDA device: kernels,
copies and fills, and not a profiler range's annotation there. `busy_s`
is the length of the union of their intervals; idle time is the rest of
the window. An idle gap is named by the innermost
host operation running at its middle.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, List, Tuple

TOP = 10
RANGE_PREFIX = "bench."    # the benchmark's own profiler ranges


def _start_end(e) -> Tuple[int, int]:
    s = e.start_ns()
    return s, s + e.duration_ns()


@contextlib.contextmanager
def device_trace(out: dict):
    """Profile the block; on exit fill `out` with the device events
    [(name, start_ns, end_ns)] and the host events [(name, start_ns,
    end_ns)], each sorted by start."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        s, t = _start_end(e)
        if e.device_type() == DeviceType.CUDA:
            if not _annotation(e):
                dev.append((e.name(), s, t))
        elif e.device_type() == DeviceType.CPU:
            host.append((e.name(), s, t))
    dev.sort(key=lambda r: r[1])
    host.sort(key=lambda r: r[1])
    out["device_events"] = dev
    out["host_events"] = host


def _annotation(e) -> bool:
    """A profiler range's shadow on the device's timeline."""
    if e.name().startswith(RANGE_PREFIX):
        return True
    flag = getattr(e, "is_user_annotation", None)
    if flag is not None and flag():
        return True
    kind = getattr(e, "activity_type", None)
    return kind is not None and "annotation" in str(kind()).lower()


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def busy_intervals(events) -> List[Tuple[int, int]]:
    """The union of the events' [start, end) as disjoint sorted
    intervals."""
    out: List[List[int]] = []
    for _, s, e in events:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(i) for i in out]


def busy_seconds(events, lo: int, hi: int) -> float:
    """Seconds of [lo, hi) in which some device event runs."""
    tot = 0
    for s, e in busy_intervals(events):
        s, e = max(s, lo), min(e, hi)
        if e > s:
            tot += e - s
    return tot / 1e9


def device_ops(events) -> List[List]:
    """The TOP device operations by total time: [[name, seconds], ...]."""
    by: Dict[str, int] = defaultdict(int)
    for n, s, e in events:
        by[n] += e - s
    top = sorted(by.items(), key=lambda kv: -kv[1])[:TOP]
    return [[n[:200], t / 1e9] for n, t in top]


def _innermost_at(host, times) -> List[str]:
    """Name of the innermost host event open at each of the sorted
    `times` (the latest started that has not ended; host events nest), in
    one sweep."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(host) and host[i][1] <= t:
            while stack and stack[-1][2] <= host[i][1]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][2] <= t:
            stack.pop()
        out.append(stack[-1][0] if stack else "host idle")
    return out


def idle_gaps(events, host, lo: int, hi: int) -> List[List]:
    """Idle time of [lo, hi) summed by the host operation around each gap,
    the TOP names: [[name, seconds], ...]."""
    gaps, prev = [], lo
    for s, e in busy_intervals(events):
        if s > prev:
            gaps.append((prev, min(s, hi)))
        prev = max(prev, e)
    if hi > prev:
        gaps.append((prev, hi))
    gaps = [(s, e) for s, e in gaps if e > s]
    names = _innermost_at(host, [(s + e) // 2 for s, e in gaps])
    by: Dict[str, int] = defaultdict(int)
    for (s, e), name in zip(gaps, names):
        by[name] += e - s
    top = sorted(by.items(), key=lambda kv: -kv[1])[:TOP]
    return [[n[:200], t / 1e9] for n, t in top]
