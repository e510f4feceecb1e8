"""One run of one cell: set-up, the measured window, the check of what the
window returned, and the result line.

The window is a closed loop of one client: whole captures solved one after
another, each from the pool in turn, each ending with its outputs read to
the host. It is timed from the start of the first solve to the end of the
last; no solve starts after `seconds`. With `trace` the same window runs
under the profiler and the per-layer metrics are read from its record.
"""

from __future__ import annotations

import contextlib
import time

import torch

from harness import judge, trace as tr
from harness.peaks import peaks_for
from harness.program import Program, structure
from harness.spec import Cell, count, read_per_layer
from harness.world import make_world

WINDOW_RANGE = tr.RANGE_PREFIX + "window"
SOLVE_RANGE = tr.RANGE_PREFIX + "solve"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_info(device: torch.device, peak: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": int(peak)}


def window(program: Program, world, seconds: float, traced: bool):
    """(outputs, pool ids, seconds) of the closed loop."""
    outs, ids = [], []
    rf = torch.profiler.record_function
    t_start = time.perf_counter()
    null = contextlib.nullcontext
    with (rf(WINDOW_RANGE) if traced else null()):
        while time.perf_counter() - t_start < seconds or not outs:
            pid = len(outs) % len(world.obs)
            t = time.perf_counter()
            with (rf(SOLVE_RANGE) if traced else null()):
                outs.append(program.solve(world.obs[pid], world.mask))
            outs[-1]["seconds"] = time.perf_counter() - t
            ids.append(pid)
    return outs, ids, time.perf_counter() - t_start


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             t0: float, workdir: str, program_hook=None):
    """(result dict, check lines) of one run; `t0` is the process start on
    the host clock, `program_hook(program)` may wrap the program (tests
    break it underneath)."""
    device = torch.device(device)
    world = make_world(cell.config, cell.traffic, seed, device, workdir)
    program = Program(world, device)
    if program_hook is not None:
        program_hook(program)
    program.solve(world.obs[0], world.mask)           # warm every shape
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    record = {}
    setup_s = time.perf_counter() - t0
    if traced:
        program.counts.reset()
        with tr.device_trace(record), program.solver_spans():
            outs, ids, secs = window(program, world, seconds, True)
            _sync(device)
    else:
        outs, ids, secs = window(program, world, seconds, False)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    frames = world.frames * len(outs)
    dev = device_info(device, peak)
    result = {"correct": False, "attempted": len(outs), "failed": 0,
              "metrics": {}, "device": dev}
    if traced:
        lo, hi = _window_ns(record)
        ev = [e for e in record["device_events"] if e[2] > lo and e[1] < hi]
        record.update(
            window_s=(hi - lo) / 1e9, window_ns=(lo, hi), device_events=ev,
            solves=[{"frames": world.frames, "host_syncs": o["host_syncs"]}
                    for o in outs],
            calls=[{"frames": c.frames, "cg_iters": c.cg_iters,
                    "linear_solver": c.linear_solver,
                    "frame_iters": int(c.frame_iters)}
                   for c in program.calls],
            launch_frames=_launch_frames(program.counts.frames),
            structure=structure(world, program.problem.tables.route),
            peaks=peaks_for(dev["kind"]), device_name=dev["kind"],
            count=lambda name: count(name, cell.root))
        busy = tr.busy_seconds(ev, lo, hi)
        dev.update(busy_s=busy, window_s=record["window_s"])
        result["metrics"] = read_per_layer(cell, record)
        result["breakdown"] = {
            "device_ops": tr.device_ops(ev),
            "idle_gaps": tr.idle_gaps(ev, record["host_events"], lo, hi)}
    program.release()
    del program
    t_check = time.perf_counter()
    j = judge.Judge(world)
    readings = j.assess(outs, ids)
    check_s = time.perf_counter() - t_check
    if not traced:
        m = result["metrics"]
        m["frames_per_s"] = {"value": frames / secs, "unit": "frames/s"}
        m["marker_err_mm"] = {"value": readings["marker_err_mm"], "unit": "mm"}
        m["v2v_body_mm"] = {"value": readings["v2v_body_mm"], "unit": "mm"}
        m["peak_mem_gib"] = {"value": peak / 2 ** 30, "unit": "GiB"}
        m["setup_s"] = {"value": setup_s, "unit": "s"}
        keep = {e["name"] for e in cell.end_to_end}
        result["metrics"] = {k: v for k, v in m.items() if k in keep}
    chk = judge.checks(readings, cell.limits)
    result["failed"] = judge.failed_solves(readings, cell.limits)
    result["correct"] = judge.passed(chk) and result["failed"] == 0
    result["checks"] = chk
    each = sorted(o["seconds"] for o in outs)
    lines = [f"seconds: set-up {setup_s:.1f}, window {secs:.1f}, "
             f"check {check_s:.1f}, solves {len(outs)}, a solve "
             f"{each[0]:.3f} / {each[len(each) // 2]:.3f} / {each[-1]:.3f}"]
    lines += [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
              for k, v in chk.items()]
    return result, lines


def _window_ns(record: dict):
    """The window's [start, end) on the profiler's clock."""
    for name, s, e in record["host_events"]:
        if name == WINDOW_RANGE:
            return s, e
    raise RuntimeError("the traced window's range is missing")


def _launch_frames(frames_counter) -> dict:
    """{kernel counter name: {frames: launches}}."""
    out = {}
    for (name, F), n in frames_counter.items():
        out.setdefault(name, {})[int(F)] = int(n)
    return out
