#!/usr/bin/env python
"""Profile the PyTorch port's stage-ii slice on a CUDA card, or time it
against another checkout of the port.

    python tools/profile_torch_slice.py [--frames 4096] [--problem dmpl]
    python tools/profile_torch_slice.py --ab OTHER_CHECKOUT [--pairs 10]

Both use `chip_smoke.bench_problem` (the bench.py protocol: full-width
SMPL+H, 46 markers, maxiter 100, two smoothing sweeps, fingers free), or
with `--problem dmpl` `chip_smoke.dmpl_problem` (the same with 8 DMPL
soft-tissue coefficients a frame).

Profile: two warm-up solves, one untraced timed solve, then one solve under
torch.profiler. Prints the untraced and traced wall, the device time summed
over kernels, the idle share of the untraced wall, the peak device memory
and the card, and writes the per-kernel table (self device time, calls) to
chiprun_out/profile_slice.txt (profile_dmpl.txt for the DMPL problem).

A/B: one worker process per checkout (this one is A, OTHER_CHECKOUT is B),
each with its own kernels and problem; after one warm-up solve each, solves
run in turns A B B A for --pairs pairs. Prints each side's median and
quartiles in seconds and frames/s, how many pairs B won, and each side's
host syncs and mean marker error.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _setup(repo, frames, problem="bench"):
    """Import the port from `repo` and build the problem on the card."""
    sys.path.insert(0, repo)
    import importlib.util
    import torch
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bp = getattr(cs, f"{problem}_problem")(frames, "cuda")
    from moshpp_torch.pipeline import stageii

    def solve():
        res = stageii.mosh_stageii_solve(bp["prob"], bp["opts"], bp["obs"],
                                         bp["mask"], prior=bp["prior"],
                                         model_type="smplh", device="cuda")
        torch.cuda.synchronize()
        return res
    return cs, solve


def _timed(solve):
    t0 = time.perf_counter()
    res = solve()
    return time.perf_counter() - t0, res


def profile(frames, problem):
    import torch
    from torch.profiler import ProfilerActivity
    cs, solve = _setup(REPO, frames, problem)
    card = cs.card_line()
    solve()
    solve()
    torch.cuda.reset_peak_memory_stats()
    wall, _ = _timed(solve)
    peak = torch.cuda.max_memory_allocated() / 2**30
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        traced, _ = _timed(solve)
    # kernel rows only: an aten op's row repeats its kernels' device time
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in rows) / 1e3     # ms
    head = (f"wall (untraced) {wall * 1e3:.1f} ms, wall (traced) "
            f"{traced * 1e3:.1f} ms, device busy {busy:.1f} ms (idle share "
            f"of the untraced wall {max(0.0, 1 - busy / (wall * 1e3)):.3f}), "
            f"peak device memory {peak:.2f} GiB, F={frames}, {problem} problem")
    lines = [head, card] + [
        f"{e.self_device_time_total / 1e3:10.2f} ms {e.count:6d}  {e.key[:120]}"
        for e in rows]
    out = os.path.join(REPO, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    name = "profile_slice.txt" if problem == "bench" else "profile_dmpl.txt"
    with open(os.path.join(out, name), "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines[:30]))


def worker(repo, frames):
    """Serve solves on request: one line in ('solve'), one JSON line out."""
    _, solve = _setup(repo, frames)
    solve()
    print("ready", flush=True)
    for line in sys.stdin:
        if line.strip() != "solve":
            break
        dt, res = _timed(solve)
        print(json.dumps({"s": dt, "syncs": res.host_syncs,
                          "err_mm": float(res.data_err.mean()) * 1e3}),
              flush=True)


def ab(other, frames, pairs):
    procs = {}
    for side, repo in (("A", REPO), ("B", os.path.abspath(other))):
        procs[side] = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", repo,
             "--frames", str(frames)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        for side, p in procs.items():
            line = p.stdout.readline()
            if line.strip() != "ready":
                raise RuntimeError(f"worker {side} did not start: {line!r}")
        runs = {"A": [], "B": []}
        for i in range(pairs):
            for side in ("AB" if i % 2 == 0 else "BA"):
                p = procs[side]
                p.stdin.write("solve\n")
                p.stdin.flush()
                runs[side].append(json.loads(p.stdout.readline()))
        wins = sum(b["s"] < a["s"] for a, b in zip(runs["A"], runs["B"]))
        for side, r in runs.items():
            s = sorted(x["s"] for x in r)
            q = statistics.quantiles(s, n=4)
            med = statistics.median(s)
            print(f"{side}: median {med:.4f} s ({frames / med:.1f} frames/s)"
                  f", quartiles {q[0]:.4f}-"
                  f"{q[2]:.4f} s, host syncs {sorted({x['syncs'] for x in r})}, "
                  f"mean marker err {r[-1]['err_mm']:.4f} mm")
        print(f"B faster in {wins} of {pairs} pairs")
    finally:
        for p in procs.values():
            p.stdin.close()
            p.wait(timeout=120)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4096)
    ap.add_argument("--ab", metavar="OTHER_CHECKOUT")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--problem", choices=("bench", "dmpl"), default="bench")
    ap.add_argument("--worker", metavar="CHECKOUT", help=argparse.SUPPRESS)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_slice: needs a CUDA device")
    if a.worker:
        worker(a.worker, a.frames)
    elif a.ab:
        ab(a.ab, a.frames, a.pairs)
    else:
        profile(a.frames, a.problem)


if __name__ == "__main__":
    main()
