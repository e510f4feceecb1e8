#!/usr/bin/env python
"""The spread of chip_smoke.py's parity wander gate on a CUDA card.

    python tools/parity_spread_torch.py [--seeds 10] [--frames 256]
                                        [--workers 3] [--threads 2]

chip_smoke.py phase 3 holds the card's solve of the bench problem at F=256
to the CPU's: the largest difference of any fitted marker coordinate
(wander) must stay within max(0.6 mm, FLOOR_FACTOR x the CPU-vs-CPU
floor), the floor being the largest wander between the CPU solve and
FLOOR_SEEDS CPU solves whose observations are moved by 1e-7 m. This tool
measures both distributions the gate compares, on the same problem and
options (`chip_smoke.bench_problem`, polish through PCG):

  - for seed 0 (the observations as they are) and seeds 1..N (moved by
    1e-7 m of noise drawn from the seed, as `chip_smoke.perturbed_markers`
    draws it): a CPU solve (plain versions, in worker processes) and a card
    solve (kernels) of the same observations, and their wander
    (card-vs-CPU);
  - for seeds 1..N the wander of the CPU solve against seed 0's
    (CPU-vs-CPU, the floor's samples).

It prints one line a seed, the two distributions (min, median, max), and
how often the gate fails by draw: over every card-vs-CPU reading and every
choice of len(FLOOR_SEEDS) floor samples among the other seeds, the share
whose reading is over max(0.6 mm, FLOOR_FACTOR x the largest sample). The
whole record goes to chiprun_out/parity_spread.json, with the card's name
and power limit.
"""

import argparse
import dataclasses
import itertools
import json
import multiprocessing
import os
import statistics
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    sys.path.insert(0, REPO)
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def observations(bp, seed):
    """The problem's observations, moved by 1e-7 m of noise from `seed`
    (chip_smoke.perturbed_markers' draw) unless seed is 0."""
    import torch
    if seed == 0:
        return bp["obs"]
    return bp["obs"] + 1e-7 * torch.randn(
        bp["obs"].shape, generator=torch.Generator().manual_seed(seed))


def options(bp):
    """Phase 3's options of the bench problem: polish through PCG."""
    return dataclasses.replace(bp["opts"], polish_solver="pcg")


def cpu_markers(frames, seed, threads):
    """Fitted markers of the CPU solve of seed's observations; runs in a
    worker process, which builds the problem from its seeds itself."""
    import torch
    torch.set_num_threads(threads)
    cs = _chip_smoke()
    bp = cs.bench_problem(frames, "cpu")
    return cs.cpu_solve(bp, options(bp), observations(bp, seed)) \
        .markers_sim.numpy()


def gate_failures(card, floor, k, factor, bar):
    """(failures, cases): over every card-vs-CPU reading of seed s and every
    k floor samples of seeds other than s, those over max(bar, factor x
    the largest sample)."""
    fails = cases = 0
    seeds = sorted(floor)
    for s, x in card.items():
        for pick in itertools.combinations([t for t in seeds if t != s], k):
            cases += 1
            fails += x > max(bar, factor * max(floor[t] for t in pick))
    return fails, cases


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--workers", type=int, default=3)
    ap.add_argument("--threads", type=int, default=2)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("parity_spread_torch: needs a CUDA device")
    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    seeds = list(range(a.seeds + 1))
    bp = cs.bench_problem(a.frames, "cpu")
    opts = options(bp)
    t0 = time.perf_counter()
    with ProcessPoolExecutor(a.workers, mp_context=multiprocessing
                             .get_context("spawn")) as pool:
        pending = {s: pool.submit(cpu_markers, a.frames, s, a.threads)
                   for s in seeds}
        torch.set_num_threads(a.threads)
        gpu = {}
        for s in seeds:
            res = cs.card_solve(dict(bp, obs=observations(bp, s)), opts)
            gpu[s] = res.markers_sim.cpu().numpy()
        cpu = {s: p.result(timeout=3000) for s, p in pending.items()}
    wall = time.perf_counter() - t0
    mm = lambda x, y: float(np.abs(x - y).max()) * 1e3
    card_cpu = {s: mm(gpu[s], cpu[s]) for s in seeds}
    cpu_cpu = {s: mm(cpu[s], cpu[0]) for s in seeds if s}
    for s in seeds:
        print(f"seed {s}: card-vs-CPU wander {card_cpu[s]:.4f} mm"
              + (f", CPU-vs-CPU {cpu_cpu[s]:.4f} mm" if s else
                 " (observations as they are)"), flush=True)
    dist = lambda v: dict(min=min(v), median=statistics.median(v),
                          max=max(v))
    k = len(cs.FLOOR_SEEDS)
    fails, cases = gate_failures(card_cpu, cpu_cpu, k, cs.FLOOR_FACTOR,
                                 cs.PARITY_WANDER_MM)
    out = dict(card=card, frames=a.frames, seeds=a.seeds, wall_s=wall,
               card_vs_cpu_mm=card_cpu, cpu_vs_cpu_mm=cpu_cpu,
               card_vs_cpu=dist(list(card_cpu.values())),
               cpu_vs_cpu=dist(list(cpu_cpu.values())),
               floor_factor=cs.FLOOR_FACTOR, floor_samples=k,
               gate_failures=fails, gate_cases=cases)
    for name in ("card_vs_cpu", "cpu_vs_cpu"):
        d = out[name]
        print(f"{name}: min {d['min']:.4f}, median {d['median']:.4f}, max "
              f"{d['max']:.4f} mm")
    print(f"gate max({cs.PARITY_WANDER_MM} mm, {cs.FLOOR_FACTOR} x the "
          f"largest of {k} floor samples) fails {fails} of {cases} draws "
          f"({wall:.0f} s)")
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "parity_spread.json"),
              "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
