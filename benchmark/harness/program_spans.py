"""The program's own spans in a traced run: the device's idle time inside
the program's `stageii.solve` span, split by the layer of the innermost
program span open at each idle gap's middle (`trace.idle_gaps`' rule, over
the host events that are program spans).

The program names its spans and their layers in
`moshpp_torch/utils/spans.py`; they are matched here by name, so that the
benchmark imports nothing of the program. A program without them (no
`stageii.solve` in the trace) reads nothing.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

from harness.trace import _innermost_at, busy_intervals

SOLVE = "stageii.solve"
# the system assembly's spans; every other `gn.` span is the batched
# dogleg's, every other `stageii.` span the schedule's
SYSTEM_SPANS = ("stageii.system", "stageii.data_rows", "stageii.normal_eq",
                "stageii.prior", "stageii.callable_prior", "stageii.cost",
                "gn.jacfwd", "gn.normal_equations")
LAYERS = ("system", "dogleg", "schedule")


def layer_of(name: str) -> Optional[str]:
    """The layer of a program span, None for any other host event."""
    if name in SYSTEM_SPANS:
        return "system"
    if name.startswith("gn."):
        return "dogleg"
    if name.startswith("stageii."):
        return "schedule"
    return None


def _solve_gaps(device_events, solves, lo: int, hi: int
                ) -> List[Tuple[int, int]]:
    """The idle gaps of [lo, hi) inside the union of the solve spans,
    sorted."""
    busy = busy_intervals(device_events)
    starts = [s for s, _ in busy]
    gaps = []
    for a, b in busy_intervals(solves):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        prev, j = a, max(bisect.bisect_right(starts, a) - 1, 0)
        while j < len(busy) and busy[j][0] < b:
            s, e = busy[j]
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
            j += 1
        if b > prev:
            gaps.append((prev, b))
    return gaps


def idle_by_layer(record: dict) -> Optional[Dict[str, float]]:
    """{layer: idle seconds inside `stageii.solve`} of the traced window,
    for the layers "system", "dogleg" and "schedule"; None without a device
    trace or without the program's spans."""
    ev, host = record.get("device_events"), record.get("host_events")
    if not ev or not host or not record.get("window_ns"):
        return None
    program = [h for h in host if layer_of(h[0])]
    solves = [h for h in program if h[0] == SOLVE]
    if not solves:
        return None
    lo, hi = record["window_ns"]
    gaps = _solve_gaps(ev, solves, lo, hi)
    names = _innermost_at(program, [(s + e) // 2 for s, e in gaps])
    out = dict.fromkeys(LAYERS, 0)
    for (s, e), name in zip(gaps, names):
        out[layer_of(name)] += e - s
    return {k: v / 1e9 for k, v in out.items()}


def idle_share(record: dict, layer: str) -> Optional[float]:
    """The idle time inside `stageii.solve` under `layer`'s spans, as a
    share of the traced window, in %."""
    by = idle_by_layer(record)
    if by is None or not record.get("window_s"):
        return None
    return 100.0 * by[layer] / record["window_s"]
