#!/usr/bin/env python
"""Time a callable body prior's rows and Jacobian on the card, as the
stage-ii system evaluates them, on a strided and on a contiguous slice.

    python tools/callable_prior_bench.py [--frames 4096]

The prior is the horse's (`mahalanobis.horse_prior`: 81 Mahalanobis rows
and 12 leg-bend rows) on a random precision factor; its slice is columns
6-87 of x (F, 111), as the horse's system takes it. For each layout: the
rows alone (`vmap(prior)`, the trial-point cost) and the system's part
(`vmap(jacfwd)` with the rows as its aux, then Jᵀr and JᵀJ by `bmm`), the
mean wall of 50 calls (CUDA-synchronized) and the three kernels with the
most device time in one traced call. Needs a CUDA device.
"""

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4096)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("callable_prior_bench: needs a CUDA device")
    sys.path.insert(0, REPO)
    from torch.profiler import ProfilerActivity, profile
    from moshpp_torch.priors.mahalanobis import (horse_prior,
                                                 mahalanobis_prior_from_arrays)
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    prior = horse_prior(mahalanobis_prior_from_arrays(
        rng.normal(size=81) * 0.1, np.tril(rng.normal(size=(81, 81)) * 0.1)
        + np.eye(81), device="cuda"))

    def rows_twice(xb):
        r = prior(xb)
        return r, r

    rows = torch.func.vmap(prior)
    jac = torch.func.vmap(torch.func.jacfwd(rows_twice, has_aux=True))

    def system(xb):
        Jp, rp = jac(xb)
        Jt = Jp.transpose(1, 2)
        return torch.bmm(Jt, rp[..., None]), torch.bmm(Jt, Jp)

    x = torch.as_tensor(rng.normal(size=(a.frames, 111)).astype(np.float32)
                        * 0.2, device="cuda")
    name = torch.cuda.get_device_name(0)
    print(f"{name}; F={a.frames}")
    for layout, xb in (("strided", x[:, 6:87]),
                       ("contiguous", x[:, 6:87].contiguous())):
        for part, fn in (("rows", rows), ("system", system)):
            fn(xb)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                fn(xb)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / 50 * 1e3
            with profile(activities=[ProfilerActivity.CUDA]) as p:
                fn(xb)
                torch.cuda.synchronize()
            top = sorted(((e.self_device_time_total, e.key[:50])
                          for e in p.key_averages()
                          if e.self_device_time_total > 0), reverse=True)[:3]
            print(f"{layout:10s} {part:6s} {ms:.4f} ms a call; top kernels "
                  + ", ".join(f"{k} {t / 1e3:.4f} ms" for t, k in top),
                  flush=True)


if __name__ == "__main__":
    main()
