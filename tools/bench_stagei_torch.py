#!/usr/bin/env python
"""Stage-i solve time and recovery on the port, and its scipy anchor (the
twin of tools/bench_stagei.py, with no JAX).

The world is that tool's (`chip_smoke.stagei_world`, the port's copy of
its `_make_world`: a synthetic SMPL+H, 46 markers 9.5 mm off the skin, 12
frames with body poses drawn from the 8-component GMM prior). Reports the
port's stage-i solve (`mosh_stagei_solve`, the 4-step annealing at
`--maxiter`): its seconds, mean data error and the recovery metrics
(`chip_smoke.stagei_recovery`).

`--scipy-anchor` also solves the same annealed objective, step by step,
with `scipy.optimize.least_squares` (TRF, `--max-nfev` evaluations a step,
xtol 1e-10) from the same init: the same frozen structure, residual rows
and free-dof mask of each step (`build_stagei_step`,
`prepare_stagei_context`), J from `torch.func.jacfwd`, both handed to scipy
as float64 numpy. Its mean data error pins the port's prior-data
equilibrium to an independent optimizer (tools/bench_stagei.py:121-176).

Usage: python tools/bench_stagei_torch.py [--frames 12] [--maxiter 100]
       [--verts 6890] [--seed 0] [--device cuda|cpu] [--scipy-anchor]
       [--max-nfev 60]
Prints one JSON line: {"metric": "stagei_seconds_per_subject", ...}.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def scipy_anchor(model, prior, world, args, kw, device, max_nfev=60):
    """The scipy solve of the annealed stage-i objective of `world`: its
    mean data error (mm)."""
    import torch
    from scipy.optimize import least_squares
    from moshpp_torch.pipeline.stagei import (_stagei_outputs, _steps,
                                              build_stagei_step,
                                              prepare_stagei_context)
    from moshpp_torch.solver.gauss_newton import fp32_matmul

    labels, vids, m2b, type_masks = args
    opts = kw["opts"]
    ctx, state = prepare_stagei_context(model, world["obs"], world["mask"],
                                        vids, m2b, type_masks, opts=opts,
                                        prior=prior, device=device)
    betas, latents, poses, trans, _ = state
    lay = ctx.lay
    with fp32_matmul():
        for anneal, detailed in _steps(opts):
            residual, pmask = build_stagei_step(ctx, betas, latents, anneal,
                                                detailed)
            free = np.where(pmask > 0)[0]
            x_full = lay.pack(betas, latents, poses, trans).cpu().numpy(
            ).astype(np.float64)
            jac = torch.func.jacfwd(residual)

            def at(xf):
                x = x_full.copy()
                x[free] = xf
                return torch.as_tensor(x, dtype=torch.float32, device=device)

            def r_np(xf):
                return residual(at(xf)).cpu().numpy().astype(np.float64)

            def j_np(xf):
                return jac(at(xf)).cpu().numpy().astype(np.float64)[:, free]

            sol = least_squares(r_np, x_full[free], jac=j_np, method="trf",
                                max_nfev=max_nfev, xtol=1e-10)
            x_full[free] = sol.x
            betas, latents, poses, trans, _ = lay.split(
                torch.as_tensor(x_full, dtype=torch.float32, device=device))
        out = _stagei_outputs(ctx, labels, betas, latents, poses, trans, None)
    return float(out.errs["data_mean_m"]) * 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--verts", type=int, default=6890)
    ap.add_argument("--maxiter", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scipy-anchor", action="store_true")
    ap.add_argument("--max-nfev", type=int, default=60)
    a = ap.parse_args()

    import torch
    import chip_smoke as cs
    from moshpp_torch.models import make_synthetic_model
    from moshpp_torch.priors.gmm import make_gmm_prior

    dev = a.device
    if torch.device(dev).type == "cuda" and not torch.cuda.is_available():
        sys.exit("bench_stagei_torch: no CUDA device; pass --device cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def model_and_prior(device):
        return (make_synthetic_model("smplh", num_verts=a.verts, seed=3,
                                     dof_per_hand=24, device=device),
                make_gmm_prior(dim=63, num_components=8, seed=1, scale=0.3,
                               device=device))

    model_c, prior_c = model_and_prior("cpu")
    world = cs.stagei_world(a.seed, a.frames, model_c, prior_c)
    model, prior = model_and_prior(dev)
    cs.stagei_solve(world, model, prior, dev, a.maxiter)      # warm-up
    t0 = time.perf_counter()
    res = cs.stagei_solve(world, model, prior, dev, a.maxiter)
    dt = time.perf_counter() - t0
    detail = {
        "frames": a.frames, "markers": cs.MARKERS,
        "verts": int(model.v_template.shape[0]), "pose_dof": model.pose_dof,
        "subjects": 1,
        "mean_marker_err_mm": float(res.errs["data_mean_m"]) * 1e3,
        "recovery": cs.stagei_recovery(model, world, res),
        "host_syncs": res.host_syncs, "device": str(torch.device(dev)),
    }
    if dev != "cpu":
        detail["card"] = cs.card_line()
    if a.scipy_anchor:
        args, kw = cs.stagei_args(world, a.maxiter)
        t1 = time.perf_counter()
        detail["scipy_anchor_err_mm"] = scipy_anchor(
            model, prior, world, args, kw, dev, a.max_nfev)
        detail["scipy_anchor_seconds"] = time.perf_counter() - t1
    print(json.dumps({"metric": "stagei_seconds_per_subject", "value": dt,
                      "unit": "s", "detail": detail}))


if __name__ == "__main__":
    main()
