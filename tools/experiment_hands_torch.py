#!/usr/bin/env python
"""Hand-pose null-space experiment on the port (the twin of
tools/experiment_hands.py, with no JAX).

Markers sit on the body, so the 48 hand-PCA dofs are observable only
through the prior; a batched solve lacks the implicit temporal regularizer
the reference gets from sequential warm starts and its velocity term
(chmosh.py:596-655), and the hands can wander in the prior's null space.
On tools/profile_stageii.py's world (built with the port,
`profile_stageii_torch.bench_world`) this measures hands v2v against the
marker fit over the two levers, as the JAX tool does:
  (a) `velo_hands`: extra velocity weight on the hand dofs only (x4, x16,
      x64);
  (b) `poseH`: a stronger hand pull to zero (x2, x4, x8);
then the best of each together.

Output: one JSON line a configuration {config, marker_err_mm, v2v_body_mm,
v2v_hands_mm, seconds} and a final recommendation line (the lowest hands
v2v at a marker error <= 0.5 mm).

Usage: python tools/experiment_hands_torch.py [--frames 512] [--maxiter 100]
       [--device cuda|cpu]
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=512)
    ap.add_argument("--maxiter", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch
    from profile_stageii_torch import bench_world, sync
    from moshpp_torch.models import lbs_forward
    from moshpp_torch.pipeline.stageii import (DEFAULT_STAGEII_WEIGHTS,
                                               mosh_stageii_solve)

    dev = args.device
    if torch.device(dev).type == "cuda" and not torch.cuda.is_available():
        sys.exit("experiment_hands_torch: no CUDA device; pass --device cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    F = args.frames
    bp = bench_world(F, dev, maxiter=args.maxiter)
    model, P = bp["model"], bp["model"].pose_dof

    # v2v over 64 frames, body and hand vertices by their dominant joint
    sub = torch.as_tensor(np.linspace(0, F - 1, 64).astype(int), device=dev)
    x_true = bp["x_true"][sub]
    v_true = lbs_forward(model, x_true[:, 3:3 + P], bp["betas"],
                         x_true[:, :3])
    n_body_joints = 1 + model.info.body_pose_dof // 3
    body_vert = torch.argmax(model.weights, dim=1) < n_body_joints

    def run(name, **wt_over):
        wts = dict(DEFAULT_STAGEII_WEIGHTS)
        wts.update(wt_over)
        opts = dataclasses.replace(bp["opts"], weights=wts)
        t0 = time.perf_counter()
        res = mosh_stageii_solve(bp["prob"], opts, bp["obs"], bp["mask"],
                                 prior=bp["prior"], model_type="smplh",
                                 device=dev)
        sync(dev)
        dt = time.perf_counter() - t0
        v_sol = lbs_forward(model, res.pose[sub], bp["betas"], res.trans[sub])
        v2v = torch.linalg.vector_norm(v_sol - v_true, dim=-1)
        out = {
            "config": name, **wt_over,
            "marker_err_mm": round(float(res.data_err.mean()) * 1e3, 4),
            "v2v_body_mm": round(float(v2v[:, body_vert].mean()) * 1e3, 3),
            "v2v_hands_mm": round(float(v2v[:, ~body_vert].mean()) * 1e3, 3),
            "seconds": round(dt, 2),
        }
        print(json.dumps(out), flush=True)
        return out

    results = [run("baseline")]
    for vh in (4.0, 16.0, 64.0):
        results.append(run(f"velo_hands_x{vh:g}", velo_hands=vh))
    for ph in (2.0, 4.0, 8.0):
        results.append(run(f"poseH_x{ph:g}", poseH=ph))
    best_vh = min(results[1:4], key=lambda r: r["v2v_hands_mm"])
    best_ph = min(results[4:7], key=lambda r: r["v2v_hands_mm"])
    results.append(run("combined", velo_hands=best_vh["velo_hands"],
                       poseH=best_ph["poseH"]))

    ok = [r for r in results if r["marker_err_mm"] <= 0.5]
    best = min(ok, key=lambda r: r["v2v_hands_mm"]) if ok else None
    print(json.dumps({
        "recommendation": best["config"] if best else "none",
        "baseline_hands_mm": results[0]["v2v_hands_mm"],
        "best_hands_mm": best["v2v_hands_mm"] if best else None,
        "constraint": "marker_err_mm <= 0.5",
    }))


if __name__ == "__main__":
    main()
