#!/usr/bin/env python
"""Measure the stage-i solve's own sensitivity to rounding on the CPU, and
the port's deviation from the JAX package beside it.

    python tools/stagei_floor.py [--seeds 10]

The problems are tests/torch_stagei_common.py's: the single stage-i solve
of tests/golden_common.py's `build_stagei_problem`, the batched solve of two
subjects and the single solve chained into stage ii. The JAX package solves
each with the observations as they are and moved by 1e-7 m of noise (seeds
7, 8, ...); the floor is the largest deviation of a noisy JAX run from the
unperturbed one: the mean data error (mm), the latent markers (max, mm) of
the single solve and of every batched subject, and the chain's mean marker
error (mm). The port (plain PyTorch on the CPU, one thread) then solves the
unperturbed problems, and its deviations from the JAX runs are printed
beside the floor. tests/test_torch_stagei.py writes the floor down as its
constants. JSON to chiprun_out/stagei_floor.json. Needs JAX; no card.
"""

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")


def deviations(a: dict, b: dict) -> dict:
    """The mean data error's difference and the latents' largest
    difference (mm) of two stage-i results as numpy dicts."""
    return dict(
        err_mm=abs(float(a["errs"]["data_mean_m"])
                   - float(b["errs"]["data_mean_m"])) * 1e3,
        lat_mm=float(np.abs(np.asarray(a["markers_latent"])
                            - np.asarray(b["markers_latent"])).max()) * 1e3)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=10)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path[:0] = [REPO, TESTS]
    import torch
    from torch_stagei_common import (CHAIN_OPTS, batched_stagei_problem,
                                     jax_stagei_runs, port_inputs)
    from golden_common import build_stagei_problem
    from moshpp_torch.pipeline import stagei, stageii

    torch.set_num_threads(1)
    seeds = tuple(range(7, 7 + args.seeds))
    runs = jax_stagei_runs((None,) + seeds)
    base = runs[None]
    floor = dict(single_err_mm=0.0, single_lat_mm=0.0, batched_err_mm=0.0,
                 batched_lat_mm=0.0, chain_mm=0.0)
    for seed in seeds:
        r = runs[seed]
        d = deviations(r["single"], base["single"])
        floor["single_err_mm"] = max(floor["single_err_mm"], d["err_mm"])
        floor["single_lat_mm"] = max(floor["single_lat_mm"], d["lat_mm"])
        for rb, bb in zip(r["batched"], base["batched"]):
            d = deviations(rb, bb)
            floor["batched_err_mm"] = max(floor["batched_err_mm"], d["err_mm"])
            floor["batched_lat_mm"] = max(floor["batched_lat_mm"], d["lat_mm"])
        floor["chain_mm"] = max(floor["chain_mm"], abs(
            float(r["chain_err"].mean()) - float(base["chain_err"].mean()))
            * 1e3)

    sp = build_stagei_problem()
    pi = port_inputs(sp)
    kw = pi["kwargs"]
    common = dict(opts=pi["opts"], prior=pi["prior"], device="cpu")
    single = stagei.mosh_stagei_solve(pi["model"], latent_labels=sp["labels"],
                                      **kw, **common)
    bp = batched_stagei_problem(sp)
    batched = stagei.mosh_stagei_solve_batched(
        pi["model"], bp["frames_obs"], bp["frames_mask"], sp["labels"],
        kw["layout_vids"], kw["m2b"], kw["type_masks"], **common)
    o2 = stageii.StageIIOptions(**CHAIN_OPTS)
    prob = stageii.prepare_stageii_problem(pi["model"], single.betas,
                                           single.markers_latent, o2,
                                           device="cpu")
    chain = stageii.mosh_stageii_solve(prob, o2, kw["frames_obs"],
                                       kw["frames_mask"], prior=pi["prior"],
                                       model_type="smplh", device="cpu")
    as_np = lambda r: dict(errs=r.errs, markers_latent=r.markers_latent)
    port = dict(single=deviations(as_np(single), base["single"]),
                batched=[deviations(as_np(r), b)
                         for r, b in zip(batched, base["batched"])],
                chain_mm=abs(float(chain.data_err.mean())
                             - float(base["chain_err"].mean())) * 1e3,
                iterations=list(single.iterations))
    out = dict(seeds=list(seeds), floor=floor, port_vs_jax=port,
               jax_single_err_mm=float(base["single"]["errs"]["data_mean_m"])
               * 1e3,
               jax_chain_err_mm=float(base["chain_err"].mean()) * 1e3)
    print(json.dumps(out))
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "stagei_floor.json"), "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
