#!/usr/bin/env python
"""Check the committed stage-ii goldens against live JAX solves, and
measure the JAX solve's own sensitivity to rounding, on the CPU.

    python tools/family_goldens_check.py [--seeds 10] [FAMILY ...]

For each family of tests/golden_common.py (default: all seven), in a fresh
interpreter each (golden_common says why): the JAX package's solve of the
family's problem against `tests/goldens/stageii_<family>.npz` at
tests/test_goldens.py's outcome tolerances (mean marker error 0.1 mm,
fitted markers 0.3 mm, trans 2 mm), and the largest deviation between that
solve and the JAX solves whose observations are moved by 1e-7 m of noise
(seeds 7, 8, ...), on the observed and on the unobserved markers and on
trans. Prints one line a family and writes the numbers to
chiprun_out/family_goldens.json. Needs JAX; no card.
"""

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
MEAN_MM, SIM_MM, TRANS_MM = 0.1, 0.3, 2.0


def check(family: str, seeds: int) -> dict:
    """The golden check and the floor of one family (run in a child)."""
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path[:0] = [REPO, TESTS]
    from golden_common import build_family_problem
    from moshpp_tpu.pipeline.stageii import mosh_stageii_solve

    fp = build_family_problem(family)
    mask = fp["mask"]

    def solve(obs):
        res = mosh_stageii_solve(fp["prob"], fp["opts"], obs, mask,
                                 prior=fp["prior"], model_type=family)
        return {k: np.asarray(getattr(res, k))
                for k in ("data_err", "markers_sim", "trans")}

    live = solve(fp["obs"])
    g = np.load(os.path.join(TESTS, "goldens", f"stageii_{family}.npz"))
    out = {"golden_mean_mm": abs(float(live["data_err"].mean())
                                 - float(g["data_err"].mean())) * 1e3,
           "golden_sim_mm": float(np.abs(live["markers_sim"]
                                         - g["markers_sim"]).max()) * 1e3,
           "golden_trans_mm": float(np.abs(live["trans"]
                                           - g["trans"]).max()) * 1e3}
    out["golden_ok"] = (out["golden_mean_mm"] < MEAN_MM
                        and out["golden_sim_mm"] < SIM_MM
                        and out["golden_trans_mm"] < TRANS_MM)
    floor = {"observed_mm": 0.0, "unobserved_mm": 0.0, "trans_mm": 0.0,
             "mean_mm": 0.0}
    for seed in range(7, 7 + seeds):
        noise = 1e-7 * np.random.default_rng(seed).standard_normal(
            fp["obs"].shape).astype(np.float32)
        r = solve(fp["obs"] + noise)
        d = np.abs(r["markers_sim"] - live["markers_sim"]).max(-1) * 1e3
        floor["observed_mm"] = max(floor["observed_mm"], float(d[mask].max()))
        if (~mask).any():
            floor["unobserved_mm"] = max(floor["unobserved_mm"],
                                         float(d[~mask].max()))
        floor["trans_mm"] = max(floor["trans_mm"], float(
            np.abs(r["trans"] - live["trans"]).max()) * 1e3)
        floor["mean_mm"] = max(floor["mean_mm"], abs(
            float(r["data_err"].mean()) - float(live["data_err"].mean()))
            * 1e3)
    out["floor"] = floor
    out["seeds"] = seeds
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("families", nargs="*")
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        print(json.dumps(check(a.families[0], a.seeds)))
        return
    sys.path[:0] = [REPO, TESTS]
    from golden_common import FAMILIES
    families = a.families or list(FAMILIES)
    procs = {f: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child", f, "--seeds",
         str(a.seeds)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for f in families}
    results = {}
    for f, p in procs.items():
        out, err = p.communicate(timeout=1800)
        if p.returncode:
            sys.exit(f"{f}: rc {p.returncode}\n{err[-2000:]}")
        r = results[f] = json.loads(out.strip().splitlines()[-1])
        fl = r["floor"]
        print(f"{f:13s} live JAX vs golden: mean {r['golden_mean_mm']:.4f}, "
              f"markers {r['golden_sim_mm']:.4f}, trans "
              f"{r['golden_trans_mm']:.4f} mm -> "
              f"{'meets' if r['golden_ok'] else 'misses'} test_goldens; "
              f"JAX floor ({r['seeds']} seeds of 1e-7 m): mean "
              f"{fl['mean_mm']:.4f}, observed markers {fl['observed_mm']:.4f}"
              f", unobserved {fl['unobserved_mm']:.4f}, trans "
              f"{fl['trans_mm']:.4f} mm", flush=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "family_goldens.json"),
              "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
