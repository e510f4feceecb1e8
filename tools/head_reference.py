#!/usr/bin/env python
"""The JAX package's head on chip_smoke.py's phase-7 session, on the CPU:
the reference phase 7b holds the card's head to.

    python tools/head_reference.py [--stagei truth|solve] [--seeds 5]
                                   [--workers 3] [--no-exact-knn]

Builds the session phase 7 builds (`chip_smoke.head_world`, with the port's
own generators on the CPU: walk.c3d at F=4096 and jog.c3d at F=1024 of a
full-width synthetic SMPL+H with a 46-marker body layout) and runs
`moshpp_tpu.pipeline.head.MoSh` on walk.c3d with the config phase 7 uses
(`chip_smoke.head_overrides`), then stage ii of all 4096 frames. Stage i
is, with `--stagei truth` (the reading 7b prints beside its own), the
session's truth as a cached stage-i pickle (`chip_smoke.head_truth_stagei`,
written by the port's code and loaded by the JAX head); with `--stagei
solve` (7b's gate on the cold run), solved from the 12 frames the frame
picker draws. Once with the observations as the files hold them, and once for
each noise seed (7, 8, ...) with the solved stages' observations moved by
1e-7 m of seeded noise (through the head's solver hooks), each run in a
spawned worker with a work directory of its own. Prints one JSON line and
writes it to chiprun_out/head_reference_<stagei>.json: each run's stage-i
data error (solve only) and stage-ii mean marker error (mm) and seconds,
and the spread (the largest difference of a noisy run's stage-ii error
from the unperturbed one's, mm). With `--exact-knn` (the default) each
worker gives the JAX package the port's knn ranking before anything is
traced (tools/jax_exact_knn.py): the truth's latents sit on their vertices'
normals, where a marker's second frame vertex is a near-tie that the JAX
package's expansion leaves to the device's rounding. Needs JAX; no card. Its work goes to
.chipwork/head_reference/.
"""

import argparse
import json
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.join(REPO, ".chipwork", "head_reference")
NOISE_M = 1e-7


def _noisy(fn, rng):
    """A solver hook: `fn` with its observations (third argument) moved by
    NOISE_M of noise from `rng`."""
    def solve(a, b, obs, *args, **kw):
        obs = np.asarray(obs)
        return fn(a, b, obs + NOISE_M * rng.standard_normal(obs.shape),
                  *args, **kw)
    return solve


def run(stagei, seed, exact_knn=True):
    """The JAX head on the session from stage i `stagei` ('truth' or
    'solve'), the observations moved by noise from `seed` (None: as they
    are), with the port's knn ranking when `exact_knn`: stage-i (solve
    only) and stage-ii errors (mm), seconds."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path[:0] = [REPO, os.path.join(REPO, "tools")]
    if exact_knn:
        from jax_exact_knn import use_exact_knn
        use_exact_knn()
    import chip_smoke
    from moshpp_tpu.pipeline import head
    from moshpp_tpu.pipeline.stagei import mosh_stagei_solve
    from moshpp_tpu.pipeline.stageii import mosh_stageii_solve

    world = chip_smoke.head_world_paths(ROOT)
    work = os.path.join(
        ROOT, f"{stagei}_{'base' if seed is None else seed}")
    t0 = time.perf_counter()
    mp = head.MoSh(**chip_smoke.head_overrides(world, work))
    if stagei == "truth":
        chip_smoke.head_truth_stagei(world, mp.cfg.to_dict(),
                                     mp.stagei_fname)
    hooks = {}
    if seed is not None:
        rng = np.random.default_rng(seed)
        hooks = dict(i=_noisy(mosh_stagei_solve, rng),
                     ii=_noisy(mosh_stageii_solve, rng))
    mp.mosh_stagei(mosh_stagei_func=hooks.get("i"))
    t_i = time.perf_counter() - t0
    mp.mosh_stageii(mosh_stageii_func=hooks.get("ii"))
    dbg = mp.stageii_data["stageii_debug_details"]
    errs_i = mp.stagei_data["stagei_debug_details"]["stagei_errs"]
    return dict(seed=seed, stagei_mm=(1e3 * float(errs_i["data_mean_m"])
                                      if errs_i else None),
                stageii_mm=1e3 * float(np.mean(
                    dbg["stageii_errs"]["data_mean_m"])),
                frames=int(len(dbg["stageii_errs"]["data_mean_m"])),
                stagei_s=t_i, seconds=time.perf_counter() - t0)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stagei", choices=("truth", "solve"),
                    default="truth")
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--workers", type=int, default=3)
    ap.add_argument("--exact-knn", action=argparse.BooleanOptionalAction,
                    default=True)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import chip_smoke
    t0 = time.perf_counter()
    chip_smoke.head_world(ROOT)
    seeds = [None] + list(range(7, 7 + args.seeds))
    with ProcessPoolExecutor(args.workers,
                             mp_context=get_context("spawn")) as pool:
        runs = list(pool.map(run, [args.stagei] * len(seeds), seeds,
                             [args.exact_knn] * len(seeds)))
    base = runs[0]["stageii_mm"]
    out = dict(stagei=args.stagei, exact_knn=args.exact_knn, runs=runs, stageii_mm=base,
               stagei_mm=runs[0]["stagei_mm"],
               spread_mm=max([abs(r["stageii_mm"] - base) for r in runs[1:]],
                             default=0.0),
               noise_m=NOISE_M, seconds=time.perf_counter() - t0)
    line = json.dumps(out)
    print(line)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out",
                           f"head_reference_{args.stagei}.json"), "w") as f:
        f.write(line + "\n")


if __name__ == "__main__":
    main()
