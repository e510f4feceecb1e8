#!/usr/bin/env python
"""The JAX package's stage-i outcome on tools/bench_stagei.py's problem, on
the CPU: the references chip_smoke.py's phases 6b, 6c and 6d hold the port
to.

    python tools/stagei_reference.py [--seeds 3] [--subjects S]
                                     [--frames 12] [--maxiter 100]
                                     [--port-world] [--workers 3]
                                     [--no-exact-knn]

Builds the subject of tools/bench_stagei.py (seed 0: full-width synthetic
SMPL+H, 46 markers, 12 frames, its model and 8-component prior) and solves
it with `moshpp_tpu.pipeline.stagei.mosh_stagei_solve` at maxiter 100, with
the observations as they are and moved by 1e-7 m of noise (seeds 7, 8,
...), each solve in a spawned worker. Prints one JSON line: the mean data
error of each solve (mm), the spread (the largest difference from the
unperturbed solve, mm), the latents' largest difference, the seconds of
each solve and each solve's recovery metrics (tools/bench_stagei.py's:
betas RMS, latent error, vid snap, v2v); writes it to
chiprun_out/stagei_reference[_f<frames>_i<maxiter>][_port].json. Needs
JAX; no card. `--frames 4 --maxiter 40` is the problem of phase 6b.

`--port-world` solves the world chip_smoke.py builds with the port's own
generators (`chip_smoke.stagei_world`, on the CPU) instead of
`_make_world`'s: the same numpy draws, but where two vertices lie within
float32 rounding of a marker, the packages may order them otherwise and
give that marker other frame vertices (tests/test_torch_stagei.py::
test_chip_smoke_world_matches_bench_stagei). With it the JAX package
solves exactly the problem the card solves.

With `--exact-knn` (the default) the JAX package ranks knn as the port does
(tools/jax_exact_knn.py, substituted in each worker before anything is
traced): where a marker's frame vertices are a near-tie, the expansion
|q|^2 - 2 q.p + |p|^2 leaves the choice to the device's rounding, and the
references would then hold the port to another problem than the one it
solves. `--no-exact-knn` runs the JAX package as it stands.

With `--subjects S` (S > 1) it is the reference of phase 6d instead: the S
subjects of `tools/bench_stagei.py --subjects S` (seeds 0 .. S-1) solved
one by one with `mosh_stagei_solve` and together with
`mosh_stagei_solve_batched`, the batch again with the observations moved
by 1e-7 m of noise (seeds 7, 8, ...) (`--workers` 3 for the single
solves, `--batched-workers` 2 for the batched ones; ~20 GB in all at
S = 8). Prints and writes (chiprun_out/stagei_batched_reference.json) each
subject's mean data error single and batched (mm), the batched solves'
per-subject errors under noise and each subject's spread (the largest
difference of a noisy batched solve from the unperturbed one, mm).
`--noise-seeds 10 11` names the noise seeds instead; `--only-noisy` runs
the noisy batches alone and prints them; `--merge LOG ...` takes every
task that the logs of earlier runs printed as done, solves the rest, and
writes the summary: so the batches of one reference can run in several
invocations at once (a batch takes hours on a loaded CPU).
"""

import argparse
import json
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor, as_completed
from multiprocessing import get_context

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M = 46


def _setup(exact_knn=False):
    """JAX on the CPU (with the port's knn ranking when `exact_knn`), the
    bench's model and prior, and the modules."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path[:0] = [REPO, os.path.join(REPO, "tools")]
    if exact_knn:
        from jax_exact_knn import use_exact_knn
        use_exact_knn()
    from moshpp_tpu.models import make_synthetic_model
    from moshpp_tpu.priors import make_gmm_prior
    model = make_synthetic_model("smplh", num_verts=6890, seed=3,
                                 dof_per_hand=24)
    prior = make_gmm_prior(dim=63, num_components=8, seed=1, scale=0.3)
    return jax, model, prior


def _worlds(seeds, frames, port_world, model, prior, jax):
    """The bench's worlds of `seeds` (numpy), by `_make_world` or by
    chip_smoke.stagei_world."""
    import jax.numpy as jnp
    from bench_stagei import _make_world
    if not port_world:
        return [_make_world(argparse.Namespace(frames=frames, markers=M,
                                               seed=s), model, prior, jnp,
                            jax) for s in seeds]
    import torch
    import chip_smoke
    torch.set_num_threads(1)
    pmodel, pprior = chip_smoke.stagei_model("cpu")
    return [chip_smoke.stagei_world(s, frames, pmodel, pprior)
            for s in seeds]


def _layout(world):
    return ([f"M{i:02d}" for i in range(M)], world["vids"],
            np.full(M, 0.0095, np.float32), {"body": np.ones(M, bool)})


def _noisy(obs, seed):
    if seed is None:
        return obs
    return obs + 1e-7 * np.random.default_rng(seed).standard_normal(
        obs.shape).astype(np.float32)


def _single_task(task):
    """One single solve in a spawned worker: the world of `subject`, the
    observations moved by the noise of `seed` (None: as they are)."""
    subject, seed, frames, maxiter, port_world, exact_knn = task
    jax, model, prior = _setup(exact_knn)
    import jax.numpy as jnp
    from bench_stagei import _recovery_metrics
    from moshpp_tpu.pipeline.stagei import StageIOptions, mosh_stagei_solve
    world = _worlds([subject], frames, port_world, model, prior, jax)[0]
    obs = _noisy(world["obs"], seed)
    t0 = time.perf_counter()
    res = mosh_stagei_solve(model, obs, np.ones(obs.shape[:2], bool),
                            *_layout(world),
                            opts=StageIOptions(maxiter=maxiter), prior=prior)
    return seed, dict(err_mm=float(res.errs["data_mean_m"]) * 1e3,
                      latents=np.asarray(res.markers_latent),
                      seconds=time.perf_counter() - t0,
                      recovery=_recovery_metrics(model, world, res, jax, jnp))


def _batched_task(task):
    """One solve of `--subjects S` in a spawned worker: ("single", s) the
    subject s alone, ("batched", seed) all S subjects in one batch, the
    observations moved by 1e-7 m of noise from `seed` (None: as they are).
    Returns (task, each subject's mean data error in mm, seconds)."""
    (kind, key), frames, maxiter, S, port_world, exact_knn = task
    jax, model, prior = _setup(exact_knn)
    from moshpp_tpu.pipeline.stagei import (StageIOptions, mosh_stagei_solve,
                                            mosh_stagei_solve_batched)
    worlds = _worlds(range(S), frames, port_world, model, prior, jax)
    obs = np.stack([w["obs"] for w in worlds])
    mask = np.ones(obs.shape[:3], bool)
    kw = dict(opts=StageIOptions(maxiter=maxiter), prior=prior)
    t0 = time.perf_counter()
    if kind == "single":
        res = [mosh_stagei_solve(model, obs[key], mask[key],
                                 *_layout(worlds[0]), **kw)]
    else:
        res = mosh_stagei_solve_batched(model, _noisy(obs, key), mask,
                                        *_layout(worlds[0]), **kw)
    errs = [float(r.errs["data_mean_m"]) * 1e3 for r in res]
    return (kind, key), errs, time.perf_counter() - t0


def _write(out, name):
    print(json.dumps(out))
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", name), "w") as f:
        json.dump(out, f, indent=1)


def single_reference(args):
    seeds = (None,) + tuple(range(7, 7 + args.seeds))
    runs = {}
    with ProcessPoolExecutor(args.workers,
                             mp_context=get_context("spawn")) as pool:
        futs = [pool.submit(_single_task, (0, s, args.frames, args.maxiter,
                                           args.port_world, args.exact_knn))
                for s in seeds]
        for f in as_completed(futs):
            seed, r = f.result()
            runs[seed] = r
            print(f"seed {seed}: {r['err_mm']:.4f} mm, {r['seconds']:.1f} s, "
                  f"{r['recovery']}", flush=True)
    base = runs[None]
    noisy = [runs[s] for s in seeds[1:]]
    out = dict(
        port_world=args.port_world, exact_knn=args.exact_knn,
        err_mm=base["err_mm"],
        noisy_err_mm=[r["err_mm"] for r in noisy],
        spread_mm=max(abs(r["err_mm"] - base["err_mm"]) for r in noisy),
        latent_spread_mm=max(float(np.abs(r["latents"] - base["latents"])
                                   .max()) * 1e3 for r in noisy),
        seconds=[runs[s]["seconds"] for s in seeds],
        recovery=base["recovery"],
        noisy_recovery=[r["recovery"] for r in noisy])
    tag = ("" if (args.frames, args.maxiter) == (12, 100)
           else f"_f{args.frames}_i{args.maxiter}")
    _write(out, f"stagei_reference{tag}{'_port' if args.port_world else ''}"
                ".json")


def _merge_logs(fnames):
    """The task results that earlier runs printed ("('batched', 7): [...] mm,
    ... s" lines), keyed by task; a later file's line wins."""
    import ast
    import re
    done = {}
    line = re.compile(r"^(\('(?:batched|single)', [^)]*\)): (\[[^\]]*\]) mm")
    for fname in fnames:
        with open(fname) as f:
            for text in f:
                m = line.match(text)
                if m:
                    done[ast.literal_eval(m.group(1))] = ast.literal_eval(
                        m.group(2))
    return done


def batched_reference(args):
    """`--subjects S`: the single and batched solves of S subjects, and the
    batched solve under noise, each in a spawned worker (with
    `--only-noisy`, the noisy batches alone; with `--merge`, no solve: the
    results earlier runs printed)."""
    S = args.subjects
    seeds = tuple(args.noise_seeds or range(7, 7 + args.seeds))
    tasks = [("batched", k) for k in seeds]
    if not args.only_noisy:
        tasks = ([("batched", None)] + tasks
                 + [("single", s) for s in range(S)])
    done = _merge_logs(args.merge) if args.merge else {}
    # a batched solve of 8 full-width subjects holds ~7.5 GB on the CPU, a
    # single one ~1.6 GB: the batched solves get their own, smaller pool
    with ProcessPoolExecutor(args.batched_workers,
                             mp_context=get_context("spawn")) as bpool, \
            ProcessPoolExecutor(args.workers,
                                mp_context=get_context("spawn")) as spool:
        futs = [(bpool if t[0] == "batched" else spool).submit(
            _batched_task, (t, args.frames, args.maxiter, S,
                            args.port_world, args.exact_knn))
            for t in tasks if t not in done]
        for f in as_completed(futs):
            key, errs, dt = f.result()
            done[key] = errs
            print(f"{key}: {[round(e, 4) for e in errs]} mm, {dt:.1f} s",
                  flush=True)
    if args.only_noisy:
        return
    base = done[("batched", None)]
    noisy = [done[("batched", k)] for k in seeds]
    _write(dict(
        port_world=args.port_world, exact_knn=args.exact_knn,
        noise_seeds=list(seeds),
        single_err_mm=[done[("single", s)][0] for s in range(S)],
        batched_err_mm=base, noisy_batched_err_mm=noisy,
        batched_spread_mm=[max(abs(n[s] - base[s]) for n in noisy)
                           for s in range(S)] if noisy else None),
        f"stagei_batched_reference{'_port' if args.port_world else ''}.json")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--subjects", type=int, default=1)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--maxiter", type=int, default=100)
    ap.add_argument("--port-world", action="store_true")
    ap.add_argument("--workers", type=int, default=3)
    ap.add_argument("--exact-knn", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--batched-workers", type=int, default=2)
    ap.add_argument("--noise-seeds", type=int, nargs="+")
    ap.add_argument("--only-noisy", action="store_true")
    ap.add_argument("--merge", nargs="+", metavar="LOG")
    args = ap.parse_args()
    if args.subjects > 1:
        batched_reference(args)
    else:
        single_reference(args)


if __name__ == "__main__":
    main()
