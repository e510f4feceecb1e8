#!/usr/bin/env python
"""Profile the PyTorch port's stage-ii slice on a CUDA card, or time it
against another checkout of the port.

    python tools/profile_torch_slice.py [--frames 4096] [--problem dmpl|face]
                                        [--fold]
    python tools/profile_torch_slice.py --ab OTHER_CHECKOUT [--pairs 10]
    python tools/profile_torch_slice.py --kernel-ab OTHER_CHECKOUT [--pairs 10]

Both use `chip_smoke.bench_problem` (the bench.py protocol: full-width
SMPL+H, 46 markers, maxiter 100, two smoothing sweeps, fingers free), or
with `--problem dmpl` `chip_smoke.dmpl_problem` (the same with 8 DMPL
soft-tissue coefficients a frame), or with `--problem face`
`chip_smoke.face_problem` (SMPL-X with 80 expressions and the jaw, the
tiled extras route). With `--fold` the solves run with
`StageIIOptions(fold_weights=True)`: the folded marker rows
`marker_rows<jac,..,fold>` in place of the unfolded ones and their weighting
pass.

Profile: two warm-up solves, one untraced timed solve, then one solve under
torch.profiler. Prints the untraced and traced wall, the device time summed
over kernels, the idle share of the untraced wall, the peak device memory
and the card, and writes the per-kernel table (self device time, calls) to
chiprun_out/profile_slice.txt (profile_<problem>.txt for the others,
with `_fold` before the suffix for the folded slice).

A/B: one worker process per checkout (this one is A, OTHER_CHECKOUT is B),
each with its own kernels and problem; after one warm-up solve each, solves
run in turns A B B A for --pairs pairs. Prints each side's median and
quartiles in seconds and frames/s, how many pairs B won, and each side's
host syncs and mean marker error.

Kernel A/B: this checkout's kernel library against OTHER_CHECKOUT's (built
by its own `moshpp_torch.kernels`), in one process. Prints, for every
`fk_smalls`/`marker_rows`/`dogleg_direction` instantiation the two builds
share, whether its SASS (cuobjdump) is identical once kernel-parameter
offsets are masked: instantiations pair by their template flags, a build
with fewer flags reading the missing trailing ones as false (so a parent's
`marker_rows<jac, ext, tiled>` pairs with `<jac, ext, tiled, fold=false>`
and a parent's untemplated `dogleg_direction` with `<pcg=false>`); then the device time of `marker_rows<jac>` and
`<jac,ext>` launched from each library on the same inputs (bench and DMPL
problems), in --pairs alternating pairs. The other checkout's
`marker_rows_launch` must take this one's arguments.
"""

import argparse
import ctypes
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _setup(repo, frames, problem="bench", fold=False):
    """Import the port from `repo` and build the problem on the card; with
    `fold` its solves fold the data weights into the marker kernel."""
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
    if fold:
        bp["opts"] = dataclasses.replace(bp["opts"], fold_weights=True)

    def solve():
        res = stageii.mosh_stageii_solve(bp["prob"], bp["opts"], bp["obs"],
                                         bp["mask"], prior=bp["prior"],
                                         model_type=bp["model_type"],
                                         device="cuda")
        torch.cuda.synchronize()
        return res
    return cs, solve


def _timed(solve):
    t0 = time.perf_counter()
    res = solve()
    return time.perf_counter() - t0, res


def profile(frames, problem, fold):
    import torch
    from torch.profiler import ProfilerActivity
    cs, solve = _setup(REPO, frames, problem, fold)
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
            f"peak device memory {peak:.2f} GiB, F={frames}, {problem} problem"
            f"{', folded weights' if fold else ''}")
    lines = [head, card] + [
        f"{e.self_device_time_total / 1e3:10.2f} ms {e.count:6d}  {e.key[:120]}"
        for e in rows]
    out = os.path.join(REPO, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    name = ("profile_slice" if problem == "bench"
            else f"profile_{problem}") + ("_fold" if fold else "") + ".txt"
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


def _sass(lib_path, cuobjdump):
    """{(kernel, flag, flag, flag, flag): SASS lines with parameter offsets
    masked} of a kernel library, keyed by the template flags of the mangled
    name padded with "0" to four (`marker_rows` has jac, ext, tiled, fold;
    `fk_smalls` the first three; `dogleg_direction` pcg)."""
    out = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                         capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : \S*?(fk_smalls|marker_rows|dogleg_direction)"
                      r"_kernel(?:I((?:Lb\dE)+)E)?", line)
        if m:
            flags = re.findall(r"Lb(\d)E", m.group(2) or "")
            cur = (m.group(1), *(flags + ["0"] * (4 - len(flags))))
            funcs[cur] = []
        elif "Function :" in line:
            cur = None
        elif cur and re.search(r"/\*[0-9a-f]{4}\*/", line):
            ins = re.sub(r"/\*[0-9a-f]{4}\*/", "", line.split(";")[0]).strip()
            funcs[cur].append(re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][P]",
                                     ins))
    return funcs


def kernel_ab(other, pairs):
    import torch
    cs, _ = _setup(REPO, 8)
    from moshpp_torch import kernels
    from moshpp_torch.ops import marker_jac as mj
    print(cs.card_line())
    _, info = kernels.library()
    other_lib = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from moshpp_torch import kernels; print(kernels.library()[1].path)",
         os.path.abspath(other)], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[-1]
    cuobjdump = os.path.join(os.path.dirname(kernels.nvcc_path()), "cuobjdump")
    mine, theirs = _sass(info.path, cuobjdump), _sass(other_lib, cuobjdump)
    for key in sorted(set(mine) & set(theirs), key=str):
        a, b = mine[key], theirs[key]
        print(f"SASS {key}: {len(a)} / {len(b)} instructions, identical with "
              f"parameter offsets masked: {a == b}")
    lib_b = ctypes.CDLL(other_lib)
    lib_b.marker_rows_launch.argtypes = kernels._SIGNATURES["marker_rows_launch"]
    lib_b.marker_rows_launch.restype = ctypes.c_int
    lib_a = kernels.library()[0]
    for problem, tag in (("bench", ""), ("dmpl", ",ext")):
        bp = getattr(cs, f"{problem}_problem")(4096, "cuda")
        tables = bp["prob"].tables
        theta, trans, extra = mj.kernel_inputs(bp["prob"].sub_model, tables,
                                               bp["x_true"])
        sm = mj.fk_smalls(theta, tables, True, extra)
        sim, jm = mj.marker_rows(sm, trans, tables, True, extra)
        p = kernels.ptr
        args = (1, sim.shape[0], tables.num_markers, tables.num_joints,
                tables.feat_n, tables.body_dof, tables.hand_dof, tables.dof,
                p(sm.grot), p(sm.atr), p(sm.feat), p(sm.wrot), p(sm.wtr),
                p(sm.dr), p(trans), p(tables.w3), p(tables.s3),
                p(tables.vsh3), p(tables.pd3), p(tables.cf),
                p(tables.ancmask), p(tables.hc), p(sim), p(jm),
                tables.n_extra, p(extra), p(sm.datr), p(tables.dv),
                torch.cuda.current_stream().cuda_stream)
        runs = {"A": lambda: lib_a.marker_rows_launch(*args),
                "B": lambda: lib_b.marker_rows_launch(*args)}
        t = {"A": [], "B": []}
        for i in range(pairs):
            for side in ("AB" if i % 2 == 0 else "BA"):
                t[side].append(cs.cuda_ms(runs[side], n=20, hold=True))
        wins = sum(b < a for a, b in zip(t["A"], t["B"]))
        print(f"marker_rows<jac{tag}> device ms: A median "
              f"{statistics.median(t['A']):.4f} ({min(t['A']):.4f}-"
              f"{max(t['A']):.4f}), B median {statistics.median(t['B']):.4f} "
              f"({min(t['B']):.4f}-{max(t['B']):.4f}), B faster in {wins} of "
              f"{pairs} pairs")
        del bp, sm, sim, jm
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4096)
    ap.add_argument("--ab", metavar="OTHER_CHECKOUT")
    ap.add_argument("--kernel-ab", metavar="OTHER_CHECKOUT")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--problem", choices=("bench", "dmpl", "face"),
                    default="bench")
    ap.add_argument("--fold", action="store_true",
                    help="solve with fold_weights=True")
    ap.add_argument("--worker", metavar="CHECKOUT", help=argparse.SUPPRESS)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_slice: needs a CUDA device")
    if a.worker:
        worker(a.worker, a.frames)
    elif a.ab:
        ab(a.ab, a.frames, a.pairs)
    elif a.kernel_ab:
        kernel_ab(a.kernel_ab, a.pairs)
    else:
        profile(a.frames, a.problem, a.fold)


if __name__ == "__main__":
    main()
