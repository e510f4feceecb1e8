#!/usr/bin/env python
"""Profiling harness for the port's stage-ii solve (the twin of
tools/profile_stageii.py, with no JAX).

The world is that tool's: a synthetic SMPL+H (6890 vertices asked, seed 3,
24 hand-PCA dofs a hand), 46 markers, an 8-component GMM on the 63 body
dofs (seed 1) and AR(1) motion, built with the port
(`chip_smoke.synthetic_problem`, the draws of bench.py). Reports the
per-phase iterations and term energies (`return_report`), the warm solve's
wall time and frames/s, and the mean marker error.

`--trace` also solves one full-system phase with
`solver.gauss_newton.batched_system_solve_traced`, set up as the JAX tool
sets it up (anneal and prior scale 1, delta_0 0.5, e_3 1e-4, every
iteration's x recorded), and writes a per-iteration CSV with the JAX tool's
columns: iter, active_frac, accept_frac, mean_f, mean_delta and the mean
term energies, sorted by name. `--micro` times one system assembly and one
dogleg direction (CUDA events on the card).

Usage: python tools/profile_stageii_torch.py [--frames N] [--device cuda|cpu]
       [--maxiter K] [--linear-solver pcg|cholesky] [--micro]
       [--trace] [--trace-out FILE.csv]
"""

import argparse
import csv
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def bench_world(frames, device, *, markers=46, maxiter=100, dof_per_hand=24,
                linear_solver="pcg", cg_iters=24, anchor_stride=8,
                weights=None):
    """tools/profile_stageii.py's world and options, built with the port:
    chip_smoke's problem dict (model, prior, prob, opts, obs, mask, x_true,
    ...)."""
    import chip_smoke
    from moshpp_torch.pipeline.stageii import StageIIOptions
    opts = StageIIOptions(maxiter=maxiter, smoothing_sweeps=2,
                          optimize_fingers=True, linear_solver=linear_solver,
                          cg_iters=cg_iters, anchor_stride=anchor_stride,
                          weights=weights)
    return chip_smoke.synthetic_problem(
        frames, device, opts, num_verts=6890, dof_per_hand=dof_per_hand,
        model_seed=3, prior_components=8, prior_seed=1, beta_scale=0.4,
        pose0_scale=0.15, markers=markers)


def sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def ms_per_call(fn, device, k=10):
    """Mean milliseconds of `fn` over k calls after one warm-up: CUDA
    events on the card, the host clock on the CPU."""
    import torch
    fn()
    sync(device)
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(k):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / k
    t0 = time.perf_counter()
    for _ in range(k):
        fn()
    return (time.perf_counter() - t0) / k * 1e3


def trace_rows(bp, aux, trace, maxiter):
    """The CSV rows of a traced solve of `aux`: per iteration the active
    and accepted shares, the mean cost and trust radius, and the mean of
    each term energy at that iteration's x."""
    import torch
    from moshpp_torch.pipeline.stageii import stageii_term_energies
    en = stageii_term_energies(bp["prob"], bp["opts"], bp["prior"],
                               bp["model_type"])
    rows = []
    for i in range(maxiter):
        e = {k: float(v.mean()) for k, v in en(trace["x"][i], aux).items()}
        rows.append({
            "iter": i,
            "active_frac": float(trace["active"][i].to(torch.float32).mean()),
            "accept_frac": float(trace["accepted"][i].to(torch.float32)
                                 .mean()),
            "mean_f": float(trace["f"][i].mean()),
            "mean_delta": float(trace["delta"][i].mean()),
            **{t: e[t] for t in sorted(e)}})
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=2048)
    ap.add_argument("--markers", type=int, default=46)
    ap.add_argument("--maxiter", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dof-per-hand", type=int, default=24)
    ap.add_argument("--linear-solver", default="pcg")
    ap.add_argument("--cg-iters", type=int, default=24)
    ap.add_argument("--anchor-stride", type=int, default=8)
    ap.add_argument("--micro", action="store_true",
                    help="also time one system assembly and one direction")
    ap.add_argument("--trace", action="store_true",
                    help="write a per-iteration optimizer trace CSV for one"
                         " full-system phase")
    ap.add_argument("--trace-out", default=os.path.join(
        REPO, "chiprun_out", "stageii_trace.csv"))
    args = ap.parse_args()

    import torch
    from moshpp_torch.pipeline.stageii import mosh_stageii_solve
    from moshpp_torch.solver.gauss_newton import fp32_matmul

    dev = args.device
    if torch.device(dev).type == "cuda" and not torch.cuda.is_available():
        sys.exit("profile_stageii_torch: no CUDA device; pass --device cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bp = bench_world(args.frames, dev, markers=args.markers,
                     maxiter=args.maxiter, dof_per_hand=args.dof_per_hand,
                     linear_solver=args.linear_solver,
                     cg_iters=args.cg_iters, anchor_stride=args.anchor_stride)
    F = args.frames

    def solve():
        out = mosh_stageii_solve(bp["prob"], bp["opts"], bp["obs"],
                                 bp["mask"], prior=bp["prior"],
                                 model_type="smplh", return_report=True,
                                 device=dev)
        sync(dev)
        return out

    t0 = time.perf_counter()
    solve()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    res, report = solve()
    dt = time.perf_counter() - t0

    print("phase      iters/frame   " + "  ".join(
        f"{t:>10s}" for t in report.term_names))
    for i, name in enumerate(report.phase_names):
        row = "  ".join(f"{report.energies_after[i, j]:10.3e}"
                        for j in range(len(report.term_names)))
        print(f"{name:10s} {report.iterations[i]:11.1f}   {row}")
    err = float(res.data_err.mean()) * 1e3
    print(f"\nfirst call (kernel loads, allocator warm-up): {first:.1f}s")
    print(f"TOTAL {dt:.2f}s -> {F / dt:.1f} frames/s | mean marker err "
          f"{err:.3f} mm | host syncs {res.host_syncs}")

    if args.trace:
        from chip_smoke import traced_phase
        from moshpp_torch.solver.gauss_newton import (
            batched_system_solve_traced)
        system, x0, aux, dl = traced_phase(bp, args.maxiter,
                                           args.linear_solver, args.cg_iters)
        t0 = time.perf_counter()
        res_t, trace = batched_system_solve_traced(system, x0, aux, dl,
                                                   e_3=1e-4, record_x=True)
        sync(dev)
        t_traced = time.perf_counter() - t0
        rows = trace_rows(bp, aux, trace, args.maxiter)
        os.makedirs(os.path.dirname(os.path.abspath(args.trace_out)),
                    exist_ok=True)
        with open(args.trace_out, "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
        print(f"\nper-iteration trace ({args.maxiter} iters x {F} frames, "
              f"{t_traced:.2f} s, host syncs {res_t.host_syncs}) -> "
              f"{args.trace_out}")
        for r in rows[:3] + rows[-2:]:
            print("  " + "  ".join(f"{k}={v:.3g}" if k != "iter"
                                   else f"it={v}" for k, v in r.items()))

    if args.micro:
        from moshpp_torch.pipeline.stageii import make_stageii_system
        from moshpp_torch.solver.pcg import dogleg_direction_batched
        prob = bp["prob"]
        P = prob.sub_model.pose_dof
        system = make_stageii_system(prob, bp["opts"], bp["prior"], "smplh")
        x = bp["x_true"].contiguous()
        D = x.shape[1]
        z = lambda *s: torch.zeros((F,) + s, device=dev)
        aux = {"markers": bp["obs"], "mask": bp["mask"].to(torch.float32),
               "wt_data": torch.full((F,), 8.7, device=dev),
               "anneal": torch.ones(F, device=dev),
               "wt_pose_scale": torch.ones(F, device=dev),
               "velo_anchor": z(P), "velo_on": z()}
        with fp32_matmul():
            ms = ms_per_call(lambda: system.system_fn(x, aux), dev)
            print(f"system assembly (marker kernels + bmm): {ms:.2f} ms/iter")
            _, g0, B0 = system.system_fn(x, aux)
            pm = torch.ones((F, D), device=dev)
            delta = torch.full((F,), 0.3, device=dev)
            plin = torch.zeros_like(g0)
            ms = ms_per_call(lambda: dogleg_direction_batched(
                g0, B0, plin, pm, delta, args.cg_iters, 1e-5), dev)
            print(f"fused dogleg direction ({args.cg_iters} cg iters): "
                  f"{ms:.2f} ms/iter")


if __name__ == "__main__":
    main()
