#!/usr/bin/env python
"""Profile the PyTorch port's stage-ii slice on a CUDA card, or time it
against another checkout of the port.

    python tools/profile_torch_slice.py [--frames 4096]
                                        [--problem dmpl|face|horse|dog|object]
                                        [--fold]
    python tools/profile_torch_slice.py --problem stagei
    python tools/profile_torch_slice.py --ab OTHER_CHECKOUT [--pairs 10]
    python tools/profile_torch_slice.py --kernel-ab OTHER_CHECKOUT [--pairs 10]
    python tools/profile_torch_slice.py --fk-frames

Both use `chip_smoke.bench_problem` (the bench.py protocol: full-width
SMPL+H, 46 markers, maxiter 100, two smoothing sweeps, fingers free), or
with `--problem dmpl` `chip_smoke.dmpl_problem` (the same with 8 DMPL
soft-tissue coefficients a frame), or with `--problem face`
`chip_smoke.face_problem` (SMPL-X with 80 expressions and the jaw, the
tiled extras route), or the other families' problems
(`chip_smoke.horse_problem`, `dog_problem`, `object_problem`: the SMAL
horse with its callable prior, the dog with its GMM on a gathered pose
slice, a rigid prop). With `--fold` the solves run with
`StageIIOptions(fold_weights=True)`: the folded marker rows
`marker_rows<jac,..,fold>` in place of the unfolded ones and their weighting
pass.

Profile: two warm-up solves, one untraced timed solve, then one solve under
torch.profiler. Prints the untraced and traced wall, the device time summed
over kernels, the traced solve's busy share of its own traced wall, the
peak device memory and the card, the device time and calls under each of
the program's spans (`moshpp_torch/utils/spans.py`: the phases, the system
assembly's data rows, normal equations, prior and cost, the dogleg's
direction, post-step, compaction and scatter; a span's device time counts
its children's), and writes the per-kernel table (self device time, calls) to
chiprun_out/profile_slice.txt (profile_<problem>.txt for the others,
with `_fold` before the suffix for the folded slice), followed by the
traced solve's launches of each `fk_smalls` and `marker_rows`
instantiation by frame count (the launch counters, `kernels.COUNTS.frames`)
and, for `fk_smalls`, those counts times its device ms at each frame count:
the solve's estimated `fk_smalls` time and the share of the small batches
(F <= 513: the anchor pass and the compaction buckets). With a callable
prior (the horse) the spans include `stageii.callable_prior` (its rows
and Jacobian by vmap(jacfwd), and their products).

Stage i (`--problem stagei`): one solve of chip_smoke.py's phase-6c
problem after a warm-up, untraced and traced: the device time under the
profiler ranges of the Jacobian (`gn.jacfwd`), the normal equations
(`gn.normal_equations`), the Cholesky direction (`gn.cholesky`) and the
freeze (`stagei.freeze`), the kernel table, the busy share, host syncs,
iterations and peak memory, to chiprun_out/profile_stagei.txt.

A/B: one worker process per checkout (this one is A, OTHER_CHECKOUT is B),
each with its own kernels and problem; after one warm-up solve each, solves
run in turns A B B A for --pairs pairs. Prints each side's median and
quartiles in seconds and frames/s, how many pairs B won, and each side's
host syncs and mean marker error.

Frames a block (`--fk-frames`): each `fk_smalls` instantiation's device
ms at F = 4096, 2048, 512, 128 with 1, 2, 3 and 4 frames a block forced,
beside the rule's choice (`marker_jac.fk_frames_per_block`).

Kernel A/B: this checkout's kernel library against OTHER_CHECKOUT's (built
by its own `moshpp_torch.kernels`), in one process. Prints, for every
`fk_smalls`/`marker_rows`/`dogleg_direction` instantiation the two builds
share, whether its SASS (cuobjdump) is identical once kernel-parameter
offsets are masked: instantiations pair by their template flags, a build
with fewer flags reading the missing trailing ones as false (so a parent's
`marker_rows<jac, ext, tiled>` pairs with `<jac, ext, tiled, fold=false>`
and a parent's untemplated `dogleg_direction` with `<pcg=false>`). Then
the device time (CUDA events, the stream held) of each of the nine
`marker_rows` instantiations launched from each library on the same inputs
at F=4096 (the bench problem for `<jac>`, `<sim>`, `<jac,fold>`; the DMPL
problem for the `ext` three; the face problem for the `tiled` three), and
of both direction launchers (`dogleg_direction`, `pcg_direction`) on
`pcg.direction_test_system(4096, D, 1e2)` at D=117/125/206 with 24 and 128
iterations, in --pairs alternating pairs (A B, B A, ...); before each
problem's `marker_rows`, its two `fk_smalls` instantiations at F = 4096,
2048, 512, 128, each pair's outputs compared (bit for bit but datr; datr's
largest difference and its effect on `marker_rows<jac,ext>`'s jm), a parent
build without `fk_smalls_occupancy` called in its own signatures; before those,
`extras_tangent` and `extras_cols` on the face problem (E=80) at the
solve's bucket sizes F = 4096, 2048, 512, 128 and on a 20-DMPL tiled
problem at F=4096, each pair's outputs compared first. Each line gives
A's and B's registers and spilled bytes (their ptxas reports), and A's
shared memory a block and blocks an SM (its occupancy queries). The other
checkout's launchers must take this one's arguments, but for the extras
kernels and `marker_rows`, whose launchers before their redesigns (a build
without `extras_cols_occupancy`, without `marker_rows_tile`) are called in
their own signatures (`marker_rows`: pd3 in place of the transposed
posedirs tables, no frames a block or hand blocks).
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


def _chip_smoke(repo):
    """Import the port from `repo` and this checkout's chip_smoke.py, TF32
    off."""
    sys.path.insert(0, repo)
    import importlib.util
    import torch
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return cs


def _setup(repo, frames, problem="bench", fold=False):
    """Import the port from `repo` and build the problem on the card; with
    `fold` its solves fold the data weights into the marker kernel."""
    import torch
    cs = _chip_smoke(repo)
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
    return cs, solve, bp


def _timed(solve):
    t0 = time.perf_counter()
    res = solve()
    return time.perf_counter() - t0, res


def profile(frames, problem, fold):
    import torch
    from torch.profiler import ProfilerActivity
    cs, solve, bp = _setup(REPO, frames, problem, fold)
    card = cs.card_line()
    solve()
    solve()
    from moshpp_torch import kernels
    torch.cuda.reset_peak_memory_stats()
    wall, _ = _timed(solve)
    peak = torch.cuda.max_memory_allocated() / 2**30
    kernels.COUNTS.reset()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        traced, _ = _timed(solve)
    by_frames = sorted(kernels.COUNTS.frames.items(),
                    key=lambda kv: (kv[0][0], -kv[0][1]))
    from moshpp_torch.utils.spans import SPANS
    rows, busy = _kernel_rows(prof.key_averages(), SPANS)
    head = (f"wall (untraced) {wall * 1e3:.1f} ms, wall (traced) "
            f"{traced * 1e3:.1f} ms, device busy {busy:.1f} ms "
            f"{_busy_share(busy, traced)}, peak device memory {peak:.2f} "
            f"GiB, F={frames}, {problem} problem"
            f"{', folded weights' if fold else ''}")
    spans = _range_lines(prof, SPANS, busy)
    lines = [head, card, "program spans:"] + spans + [
        f"{e.self_device_time_total / 1e3:10.2f} ms {e.count:6d}  {e.key[:120]}"
        for e in rows] + ["launches of the traced solve by frame count:"] + [
        f"{n:6d} x F={F:<6d} {name}" for (name, F), n in by_frames] + (
        _fk_buckets(cs, bp, by_frames))
    out = os.path.join(REPO, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    name = ("profile_slice" if problem == "bench"
            else f"profile_{problem}") + ("_fold" if fold else "") + ".txt"
    with open(os.path.join(out, name), "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines[:len(spans) + 30]
                    + lines[len(spans) + len(rows) + 3:]))


def profile_stagei():
    """One stage-i solve of chip_smoke.py's phase-6c problem (the
    tools/bench_stagei.py protocol) after a warm-up, untraced and under
    torch.profiler: the device time under each profiler range (the
    Jacobian by jacfwd, the normal equations' bmm, the Cholesky direction,
    the host-side freeze), the kernel table, the idle share of the
    untraced wall, host syncs, iterations and peak device memory; the table
    to chiprun_out/profile_stagei.txt."""
    import torch
    from torch.profiler import ProfilerActivity
    cs = _chip_smoke(REPO)
    card = cs.card_line()
    model_c, prior_c = cs.stagei_model("cpu")
    world = cs.stagei_world(0, cs.STAGEI_FRAMES, model_c, prior_c)
    model = model_c.to("cuda")
    prior = cs.prior_on(dict(prior=prior_c), "cuda")
    solve = lambda: cs.stagei_solve(world, model, prior, "cuda")
    solve()
    torch.cuda.reset_peak_memory_stats()
    wall, res = _timed(solve)
    peak = torch.cuda.max_memory_allocated() / 2**30
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        traced, res_t = _timed(solve)
    from moshpp_torch.utils.spans import (CHOLESKY, FREEZE, JACFWD,
                                          NORMAL_EQUATIONS, SPANS)
    names = (JACFWD, NORMAL_EQUATIONS, CHOLESKY, FREEZE)
    events = prof.key_averages()
    rows, busy = _kernel_rows(events, SPANS)
    ranges = _range_lines(prof, names, busy)
    head = (f"stage i: wall (untraced) {wall * 1e3:.1f} ms, wall (traced) "
            f"{traced * 1e3:.1f} ms, device busy {busy:.1f} ms "
            f"{_busy_share(busy, traced)}, "
            f"peak device memory {peak:.2f} GiB, host syncs {res.host_syncs}"
            f", iterations {res.iterations} (traced {res_t.iterations}), "
            f"{cs.STAGEI_FRAMES} frames, {cs.MARKERS} markers")
    lines = [head, card, "profiler ranges:"] + ranges + [
        f"{e.self_device_time_total / 1e3:10.2f} ms {e.count:6d}  {e.key[:120]}"
        for e in rows]
    out = os.path.join(REPO, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "profile_stagei.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines[:40]))


def _kernel_rows(events, ranges):
    """(the device rows of `key_averages()` that are kernels, copies and
    fills, by self device time; their total in ms). An aten op's row
    repeats its kernels' device time, and a profiler range may also show
    as a device-side annotation row: both are left out."""
    import torch
    rows = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.key not in ranges]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return rows, sum(e.self_device_time_total for e in rows) / 1e3


def _busy_share(busy_ms, traced_s):
    """The traced solve's device time over its own traced wall."""
    return f"(busy share of the traced wall {busy_ms / (traced_s * 1e3):.3f})"


def _range_lines(prof, names, busy_ms):
    """A line for each profiler range of `names` the profile saw: its
    calls, the device time of the work launched inside it and its host
    time. A kernel, copy or fill counts under every range open when its
    launch ran on the host (the runtime call of the same correlation id):
    `key_averages()` leaves out the kernels launched through ctypes, the
    hand-written ones."""
    import bisect
    from torch.autograd import DeviceType
    dev, launch_at, ranges = {}, {}, []
    for e in prof.profiler.kineto_results.events():
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.name() in names:
            if e.device_type() == DeviceType.CPU:
                ranges.append((e.name(), start, end))
        elif e.device_type() == DeviceType.CUDA:
            dev[e.correlation_id()] = dev.get(e.correlation_id(), 0) + (
                end - start)
        elif e.name().startswith(("cuda", "cu")) and e.correlation_id():
            launch_at[e.correlation_id()] = start
    launches = sorted((t, dev[c]) for c, t in launch_at.items() if c in dev)
    times = [t for t, _ in launches]
    cum = [0]
    for _, ns in launches:
        cum.append(cum[-1] + ns)
    by = {}
    for name, start, end in ranges:
        i, j = bisect.bisect_left(times, start), bisect.bisect_right(times,
                                                                      end)
        calls, ns, host = by.get(name, (0, 0, 0))
        by[name] = (calls + 1, ns + cum[j] - cum[i], host + end - start)
    lines = []
    for name in names:
        if name in by:
            calls, ns, host = by[name]
            lines.append(f"  {name}: {calls} calls, {ns / 1e6:.1f} ms device "
                         f"({100 * ns / 1e6 / busy_ms:.1f} % of busy), "
                         f"{host / 1e6:.1f} ms host")
    return lines


def _fk_buckets(cs, bp, by_frames, small=513):
    """Each fk_smalls instantiation's launches at each frame count times its
    device ms there (on the problem's first F frames of x_true, `cuda_ms`
    with the stream held): the solve's estimated fk_smalls time and the
    share of the launches at F <= `small` (the anchor pass's 513 frames and
    the compaction buckets)."""
    from moshpp_torch.ops import marker_jac as mj
    t = bp["prob"].tables
    out = ["fk_smalls device ms a solve from the launches by frame count:"]
    for with_jac in (True, False):
        name = mj._names(with_jac, t.route)[0]
        total = part = 0.0
        for (kernel, F), n in by_frames:
            if kernel != name:
                continue
            theta, _, extra = mj.kernel_inputs(bp["prob"].sub_model, t,
                                               bp["x_true"][:F])
            if t.route == "tiled":
                jshift, _ = mj.extra_shifts(t, extra)
                fn = lambda: mj.fk_smalls_tiled(theta, jshift, t, with_jac)
            else:
                fn = lambda: mj.fk_smalls(theta, t, with_jac, extra)
            ms = n * cs.cuda_ms(fn, n=10, hold=True)
            total += ms
            part += ms if F <= small else 0.0
        out.append(f"  {name}: {total:.3f} ms, of which F <= {small}: "
                   f"{part:.3f} ms ({100 * part / max(total, 1e-12):.1f} %)")
    return out


def worker(repo, frames):
    """Serve solves on request: one line in ('solve'), one JSON line out."""
    _, solve, _ = _setup(repo, frames)
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
        m = re.search(r"Function : \S*?(fk_smalls|marker_rows|dogleg_direction"
                      r"|extras_tangent|extras_cols)_kernel(?:I((?:Lb\dE)+)E)?",
                      line)
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


def _ptxas(log):
    """{(kernel, flag, flag, flag, flag): (registers, spill bytes)} from an
    nvcc log's ptxas report, keyed as `_sass` keys."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for \S*?(fk_smalls|marker_rows|"
                      r"dogleg_direction|extras_tangent|extras_cols)_kernel"
                      r"(?:I((?:Lb\dE)+)E)?", line)
        if m:
            flags = re.findall(r"Lb(\d)E", m.group(2) or "")
            cur = (m.group(1), *(flags + ["0"] * (4 - len(flags))))
            out[cur] = [None, 0]
        elif cur and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            out[cur][1] = int(st) + int(ld)
        elif cur and "Used" in line and "registers" in line:
            out[cur][0] = int(re.search(r"Used (\d+) registers", line).group(1))
            cur = None
    return out


# marker_rows launchers timed by --kernel-ab: (name, problem, launcher,
# with_jac, SASS key flags)
AB_ROWS = (("marker_rows<jac>", "bench", "marker_rows_launch", 1, "1000"),
           ("marker_rows<sim>", "bench", "marker_rows_launch", 0, "0000"),
           ("marker_rows<jac,fold>", "bench", "marker_rows_fold_launch", 1,
            "1001"),
           ("marker_rows<jac,ext>", "dmpl", "marker_rows_launch", 1, "1100"),
           ("marker_rows<sim,ext>", "dmpl", "marker_rows_launch", 0, "0100"),
           ("marker_rows<jac,ext,fold>", "dmpl", "marker_rows_fold_launch", 1,
            "1101"),
           ("marker_rows<jac,tiled>", "face", "marker_rows_tiled_launch", 1,
            "1010"),
           ("marker_rows<sim,tiled>", "face", "marker_rows_tiled_launch", 0,
            "0010"),
           ("marker_rows<jac,tiled,fold>", "face",
            "marker_rows_tiled_fold_launch", 1, "1011"))


_P, _I = ctypes.c_void_p, ctypes.c_int


# the marker_rows launchers before their redesign (builds without
# `marker_rows_tile`): pd3 in place of pdt and pd64, no frames a block and
# hand blocks
ROWS_OLD_SIGNATURES = {
    "marker_rows_launch": [_I] * 8 + [_P] * 16 + [_I] + [_P] * 4,
    "marker_rows_fold_launch": [_I] * 7 + [_P] * 16 + [_I] + [_P] * 6,
    "marker_rows_tiled_launch": [_I] * 9 + [_P] * 19,
    "marker_rows_tiled_fold_launch": [_I] * 8 + [_P] * 21,
}


def _rows_args(launcher, with_jac, tables, sm, trans, extra, vpshift, obs, w,
               outs, pd3=None):
    """The argument tuple of one marker_rows launcher, stream excluded, in
    this tree's signature, or with `pd3` (the posedirs rows in feature
    order, kept alive by the caller) the one before the redesign."""
    from moshpp_torch import kernels
    from moshpp_torch.ops import marker_jac as mj
    p = kernels.ptr
    t = tables
    head = (t.num_joints, t.feat_n, t.body_dof, t.hand_dof, t.dof)
    new = pd3 is None
    pd = (p(t.pdt), p(t.pd64)) if new else (p(pd3),)
    smalls = (p(sm.grot), p(sm.atr), p(sm.feat), p(sm.wrot), p(sm.wtr),
              p(sm.dr), p(trans), p(t.w3), p(t.s3), p(t.vsh3), *pd,
              p(t.cf), p(t.ancmask), p(t.hc))
    F, M = trans.shape[0], t.num_markers
    tail = ((mj.rows_frames_per_block(F, M, kernels.sm_count(trans.device),
                                      bool(with_jac)), t.hand_blocks)
            if new else ())
    sim, jm, uv = outs
    if launcher == "marker_rows_launch":
        return (with_jac, F, M, *head, *smalls, p(sim), p(jm), t.n_extra,
                p(extra), p(sm.datr), p(t.dv), *tail)
    if launcher == "marker_rows_fold_launch":
        return (F, M, *head, *smalls, p(sim), p(jm), t.n_extra, p(extra),
                p(sm.datr), p(t.dv), p(obs), p(w), *tail)
    if launcher == "marker_rows_tiled_launch":
        return (with_jac, F, M, *head, t.n_extra, *smalls, p(vpshift),
                p(sim), p(jm), p(uv), *tail)
    return (F, M, *head, t.n_extra, *smalls, p(vpshift), p(sim), p(jm),
            p(uv), p(obs), p(w), *tail)


# the tiled extras kernels' launchers before their redesign (builds without
# `extras_cols_occupancy`): the ancestor masks in place of the parents, w3
# in place of the sparse weight lists and their count
EXTRAS_OLD_SIGNATURES = {
    "extras_tangent_launch": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    "extras_cols_launch": [_I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
}


def _extras_launches(lib, t, sm, datr_in, uv, datr_out, jm):
    """(tangent, cols) zero-argument launches of one build's extras kernels
    on these inputs, in its own signatures: a build with
    `extras_cols_occupancy` takes this tree's (parents, the sparse weight
    lists, dvt), one without the earlier ones (ancestor masks, w3, dv)."""
    from moshpp_torch import kernels
    import torch
    new = hasattr(lib, "extras_cols_occupancy")
    sigs = kernels._SIGNATURES if new else EXTRAS_OLD_SIGNATURES
    for name in ("extras_tangent_launch", "extras_cols_launch"):
        getattr(lib, name).argtypes = sigs[name]
        getattr(lib, name).restype = ctypes.c_int
    p = kernels.ptr
    F = sm.q.shape[0]
    M, J, E, D = t.num_markers, t.num_joints, t.n_extra, t.dof
    stream = torch.cuda.current_stream().cuda_stream
    tan = (F, J, E, p(sm.q), p(sm.grot), p(t.dtrel), p(t.djnt),
           p(t.parents_t if new else t.ancmask), p(datr_out), stream)
    if new:
        cols = (F, M, J, E, D, t.wnz_j.shape[-1], p(datr_in), p(uv),
                p(t.wnz_j), p(t.wnz_w), p(t.dvt), p(jm), stream)
    else:
        cols = (F, M, J, E, D, p(datr_in), p(uv), p(t.w3), p(t.dv), p(jm),
                stream)
    return (lambda: lib.extras_tangent_launch(*tan),
            lambda: lib.extras_cols_launch(*cols))


# fk_smalls' launchers before their redesign (builds without
# `fk_smalls_occupancy`): the parents and depth levels in place of the frames
# a block, the ancestor masks after dtrel (none on the tiled route)
FK_OLD_SIGNATURES = {
    "fk_smalls_launch": [_I, _P, _P, _P, _I, _P, _P, _I, _I, _P, _P, _P, _P,
                         _P, _P, _I, _P, _P, _P, _P, _P, _P],
    "fk_smalls_tiled_launch": [_I, _P, _P, _P, _I, _P, _P, _I, _I, _P, _P,
                               _P, _P, _P, _P, _P, _P, _P],
}


def _fk_launch(lib, t, jac, theta, extra, jshift, o):
    """A zero-argument launch of one build's fk_smalls instantiation on
    these inputs into the JointSmalls o, in the build's own signature."""
    import torch
    from moshpp_torch import kernels
    from moshpp_torch.models.body_model import tree_depths
    from moshpp_torch.ops import marker_jac as mj
    new = hasattr(lib, "fk_smalls_occupancy")
    tiled = t.route == "tiled"
    name = "fk_smalls_tiled_launch" if tiled else "fk_smalls_launch"
    fn = getattr(lib, name)
    fn.argtypes = (kernels._SIGNATURES if new else FK_OLD_SIGNATURES)[name]
    fn.restype = ctypes.c_int
    p = kernels.ptr
    F, J = theta.shape[0], t.num_joints
    outs = (p(o.grot), p(o.atr), p(o.feat), p(o.wrot), p(o.wtr), p(o.dr))
    if new:
        nf = mj.fk_frames_per_block(F, kernels.sm_count(theta.device),
                                    bool(jac), t.route)
        head = (jac, nf, p(theta), p(t.ancmask), p(t.jnts), p(t.trel), F, J,
                *outs)
    else:
        depth = tree_depths(t.parents)
        o._depth = torch.tensor(depth, dtype=torch.int32, device=theta.device)
        head = (jac, p(theta), p(t.parents_t), p(o._depth), max(depth),
                p(t.jnts), p(t.trel), F, J, *outs)
    if tiled:
        tail = (p(jshift), p(o.q))
    else:
        tail = (t.n_extra, p(extra), p(t.djnt), p(t.dtrel),
                *(() if new else (p(t.ancmask),)), p(o.datr))
    stream = torch.cuda.current_stream().cuda_stream
    args = (*head, *tail, stream)
    return lambda: fn(*args)


FK_FIELDS = ("grot", "atr", "feat", "wrot", "wtr", "dr", "q")


def fk_ab(cs, lib_a, lib_b, bp, pairs, res):
    """The problem's two fk_smalls instantiations from the two builds in
    alternating pairs at the solve's frame counts F = 4096, 2048, 512, 128:
    each pair's outputs compared first (bit for bit but datr; datr's largest
    difference and, with the Jacobian and inline extras, its effect on this
    tree's marker_rows<jac,ext> jm)."""
    import types
    import torch
    from moshpp_torch import kernels
    from moshpp_torch.ops import marker_jac as mj
    t = bp["prob"].tables
    theta, trans, extra = mj.kernel_inputs(bp["prob"].sub_model, t,
                                           bp["x_true"])
    jshift = mj.extra_shifts(t, extra)[0] if t.route == "tiled" else None
    route = {"": 0, "ext": 1, "tiled": 2}[t.route]
    for jac in (1, 0):
        name = mj._names(bool(jac), t.route)[0]
        key = ("fk_smalls", str(jac), str(int(route == 1)),
               str(int(route == 2)), "0")
        for F in (4096, 2048, 512, 128):
            th = theta[:F]
            ex = None if extra is None else extra[:F]
            js = None if jshift is None else jshift[:F]
            like = (mj.fk_smalls_tiled(th, js, t, bool(jac)) if route == 2
                    else mj.fk_smalls(th, t, bool(jac), ex))
            outs = {s: types.SimpleNamespace(**{
                f: None if v is None else torch.full_like(v, float("nan"))
                for f, v in zip(like._fields, like)}) for s in "AB"}
            fns = {s: _fk_launch(lib, t, jac, th, ex, js, outs[s])
                   for s, lib in (("A", lib_a), ("B", lib_b))}
            for s in "AB":
                assert fns[s]() == 0, (name, F, s)
            torch.cuda.synchronize()
            a_o, b_o = outs["A"], outs["B"]
            same = all(torch.equal(getattr(a_o, f), getattr(b_o, f))
                       for f in FK_FIELDS if getattr(a_o, f) is not None)
            note = f"; outputs but datr bit for bit: {same}"
            if a_o.datr is not None:
                note += (f", datr |A - B| "
                         f"{float((a_o.datr - b_o.datr).abs().max()):.3g}")
                jm = {s: mj.marker_rows(mj.JointSmalls(**{
                    f: getattr(outs[s], f) for f in like._fields}),
                    trans[:F], t, True, ex)[1] for s in "AB"}
                note += (f", marker_rows<jac,ext> jm |A - B| "
                         f"{float((jm['A'] - jm['B']).abs().max()):.3g} "
                         f"(|jm| max {float(jm['A'].abs().max()):.3g})")
                del jm
            smem, threads = ctypes.c_int(), ctypes.c_int()
            nf = mj.fk_frames_per_block(F, kernels.sm_count(theta.device),
                                        bool(jac), t.route)
            blocks = lib_a.fk_smalls_occupancy(
                jac, route, t.num_joints, t.n_extra if route == 1 else 0, nf,
                ctypes.byref(smem), ctypes.byref(threads))
            a, b = _ab_pairs(cs, fns, pairs, 10)
            _ab_line(f"{name}@F={F}", a, b, pairs,
                     f"{note}; A: {res(key, 'A')}, {nf} frames, "
                     f"{threads.value} threads, {smem.value} B shared memory "
                     f"a block, {blocks} blocks an SM; B: {res(key, 'B')}")
            del outs, fns, like
    torch.cuda.empty_cache()


def _dmpl_tiled_problem(cs, frames):
    """chip_smoke's DMPL problem with 20 DMPL dims, which take the tiled
    route: 36 shape dirs (DMPLs in columns 16-35), D = 3 + 114 + 20."""
    from moshpp_torch.pipeline.stageii import StageIIOptions
    return cs.synthetic_problem(
        frames, "cuda", StageIIOptions(maxiter=100, smoothing_sweeps=2,
                                       optimize_fingers=True,
                                       optimize_dynamics=True, num_dmpls=20),
        num_verts=6890, dof_per_hand=24, model_seed=3, prior_components=8,
        prior_seed=1, beta_scale=0.4, pose0_scale=0.15, num_shape_dirs=36)


def extras_ab(cs, lib_a, lib_b, pairs, res):
    """extras_tangent and extras_cols of the two builds in alternating
    pairs: the face problem (E=80) at the solve's bucket sizes F = 4096,
    2048, 512, 128 and the 20-DMPL tiled problem at F=4096, on the inputs
    of this tree's tiled kernels; each pair's outputs compared first."""
    import torch
    from moshpp_torch.ops import marker_jac as mj
    I = ctypes.c_int
    for label, make, sizes in (
            ("face", cs.face_problem, (4096, 2048, 512, 128)),
            ("dmpl20", lambda F, dev: _dmpl_tiled_problem(cs, F), (4096,))):
        bp = make(4096, "cuda")
        t = bp["prob"].tables
        theta, trans, extra = mj.kernel_inputs(bp["prob"].sub_model, t,
                                               bp["x_true"])
        jshift, vpshift = mj.extra_shifts(t, extra)
        sm_all = mj.fk_smalls_tiled(theta, jshift, t, True)
        _, jm_all, uv_all = mj.marker_rows_tiled(sm_all, trans, vpshift, t,
                                                 True)
        datr_all = mj.extras_tangent(sm_all.q, sm_all.grot, t)
        for F in sizes:
            sm = sm_all._replace(q=sm_all.q[:F], grot=sm_all.grot[:F])
            datr_in, uv = datr_all[:F], uv_all[:F]
            outs = {s: (torch.empty_like(datr_in), jm_all[:F].clone())
                    for s in "AB"}
            fns = {s: _extras_launches(lib, t, sm, datr_in, uv, *outs[s])
                   for s, lib in (("A", lib_a), ("B", lib_b))}
            for s in "AB":
                assert fns[s][0]() == 0 and fns[s][1]() == 0, (label, F, s)
            torch.cuda.synchronize()
            d_datr = float((outs["A"][0] - outs["B"][0]).abs().max())
            d_cols = float((outs["A"][1] - outs["B"][1]).abs().max())
            smem, warps = I(), I()
            blocks = lib_a.extras_tangent_occupancy(
                F, t.num_joints, t.n_extra, ctypes.byref(smem),
                ctypes.byref(warps))
            a, b = _ab_pairs(cs, {s: fns[s][0] for s in "AB"}, pairs, 10)
            _ab_line(f"extras_tangent@{label},F={F}", a, b, pairs,
                     f"; |A - B| {d_datr:.3g}; A: "
                     f"{res(('extras_tangent', '0', '0', '0', '0'), 'A')}, "
                     f"{smem.value} B shared memory, {warps.value} warps a "
                     f"block, {blocks} blocks an SM; B: "
                     f"{res(('extras_tangent', '0', '0', '0', '0'), 'B')}")
            blocks = lib_a.extras_cols_occupancy(
                t.num_markers, t.num_joints, t.n_extra, t.wnz_j.shape[-1],
                ctypes.byref(smem))
            a, b = _ab_pairs(cs, {s: fns[s][1] for s in "AB"}, pairs, 10)
            _ab_line(f"extras_cols@{label},F={F}", a, b, pairs,
                     f"; |A - B| {d_cols:.3g}; A: "
                     f"{res(('extras_cols', '0', '0', '0', '0'), 'A')}, "
                     f"{smem.value} B shared memory, {blocks} blocks an "
                     f"SM, K={t.wnz_j.shape[-1]}; B: "
                     f"{res(('extras_cols', '0', '0', '0', '0'), 'B')}")
            del outs, fns
        del bp, sm_all, jm_all, uv_all, datr_all
        torch.cuda.empty_cache()


def _ab_pairs(cs, runs, pairs, n):
    """Device ms of runs["A"] and runs["B"] in `pairs` alternating pairs,
    timed by chip_smoke's `cuda_ms`; (A list, B list)."""
    t = {"A": [], "B": []}
    for i in range(pairs):
        for side in ("AB" if i % 2 == 0 else "BA"):
            t[side].append(cs.cuda_ms(runs[side], n=n, hold=True))
    return t["A"], t["B"]


def _ab_line(name, a, b, pairs, extra=""):
    wins = sum(x < y for x, y in zip(a, b))
    print(f"{name} device ms: A median {statistics.median(a):.4f} "
          f"({min(a):.4f}-{max(a):.4f}), B median {statistics.median(b):.4f} "
          f"({min(b):.4f}-{max(b):.4f}), A faster in {wins} of {pairs} pairs"
          f"{extra}", flush=True)


def kernel_ab(other, pairs):
    import torch
    cs, _, _ = _setup(REPO, 8)
    from moshpp_torch import kernels
    from moshpp_torch.ops import marker_jac as mj
    from moshpp_torch.solver import pcg
    print(cs.card_line())
    lib_a, info = kernels.library()
    other_info = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from moshpp_torch import kernels; i = kernels.library()[1]; "
         "print(i.path); print(i.path.parent / 'nvcc.log')",
         os.path.abspath(other)], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    other_lib, other_log = other_info[-2], other_info[-1]
    cuobjdump = os.path.join(os.path.dirname(kernels.nvcc_path()), "cuobjdump")
    mine, theirs = _sass(info.path, cuobjdump), _sass(other_lib, cuobjdump)
    for key in sorted(set(mine) & set(theirs), key=str):
        a, b = mine[key], theirs[key]
        print(f"SASS {key}: {len(a)} / {len(b)} instructions, identical with "
              f"parameter offsets masked: {a == b}")
    res_a = _ptxas(info.log)
    res_b = _ptxas(open(other_log).read()) if os.path.exists(other_log) else {}
    lib_b = ctypes.CDLL(other_lib)
    new_b = hasattr(lib_b, "marker_rows_tile")
    for name in ("marker_rows_launch", "marker_rows_fold_launch",
                 "marker_rows_tiled_launch", "marker_rows_tiled_fold_launch",
                 "dogleg_direction_launch", "pcg_direction_launch"):
        sigs = (kernels._SIGNATURES if new_b or name not in ROWS_OLD_SIGNATURES
                else ROWS_OLD_SIGNATURES)
        getattr(lib_b, name).argtypes = sigs[name]
        getattr(lib_b, name).restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    I = ctypes.c_int
    occ_a = {}

    def res(key, res_side):
        if isinstance(res_side, str):
            res_side = res_a if res_side == "A" else res_b
        r = res_side.get(key)
        return "n/a" if r is None else f"{r[0]} registers, {r[1]} B spilled"

    extras_ab(cs, lib_a, lib_b, pairs, res)

    for problem in ("bench", "dmpl", "face"):
        bp = getattr(cs, f"{problem}_problem")(4096, "cuda")
        t = bp["prob"].tables
        theta, trans, extra = mj.kernel_inputs(bp["prob"].sub_model, t,
                                               bp["x_true"])
        F, M = trans.shape[0], t.num_markers
        fk_ab(cs, lib_a, lib_b, bp, pairs, res)
        vpshift = None
        if t.route == "tiled":
            jshift, vpshift = mj.extra_shifts(t, extra)
            sm_jac = mj.fk_smalls_tiled(theta, jshift, t, True)
            sm_sim = mj.fk_smalls_tiled(theta, jshift, t, False)
        else:
            sm_jac = mj.fk_smalls(theta, t, True, extra)
            sm_sim = mj.fk_smalls(theta, t, False, extra)
        gen = torch.Generator(device="cuda").manual_seed(0)
        obs = torch.randn((F, M, 3), device="cuda", generator=gen)
        w = torch.rand((F, M), device="cuda", generator=gen) * 400.0
        e = lambda *sh: torch.empty(sh, dtype=torch.float32, device="cuda")
        outs = (e(F, M, 3), e(F, M, 3, t.dof), e(F, M, mj.UV_WIDTH))
        pd3 = t.pd3
        route = {"": 0, "ext": 1, "tiled": 2}[t.route]
        for name, prob, launcher, jac, flags in AB_ROWS:
            if prob != problem:
                continue
            key = ("marker_rows", *flags)
            sm = sm_jac if jac else sm_sim
            args = _rows_args(launcher, jac, t, sm, trans, extra, vpshift,
                              obs, w, outs)
            args_b = _rows_args(launcher, jac, t, sm, trans, extra, vpshift,
                                obs, w, outs, None if new_b else pd3)
            fa, fb = getattr(lib_a, launcher), getattr(lib_b, launcher)
            assert fa(*args, stream) == 0 and fb(*args_b, stream) == 0, name
            smem = I()
            blocks = lib_a.marker_rows_occupancy(
                jac, route, int(flags[3]), t.num_joints, t.feat_n, t.body_dof,
                t.hand_dof, t.n_extra, t.hand_blocks, ctypes.byref(smem))
            a, b = _ab_pairs(cs, {"A": lambda: fa(*args, stream),
                                  "B": lambda: fb(*args_b, stream)}, pairs,
                             10)
            _ab_line(name, a, b, pairs,
                     f"; A: {res(key, res_a)}, {smem.value} B shared memory, "
                     f"{blocks} blocks an SM; B: {res(key, res_b)}")
        del bp, sm_jac, sm_sim, outs, obs, w, pd3
        torch.cuda.empty_cache()
    for D in (117, 125, 206):
        g, B, plin, mask, delta = pcg.direction_test_system(4096, D, 1e2,
                                                             seed=D,
                                                             device="cuda")
        p = kernels.ptr
        o = [torch.empty_like(g) for _ in range(2)] + [torch.empty_like(delta)]
        ok = torch.empty(4096, dtype=torch.bool, device="cuda")
        for mode in (0, 1):
            smem, threads = I(), I()
            blocks = lib_a.dogleg_direction_occupancy(mode, D, ctypes.byref(smem),
                                                      ctypes.byref(threads))
            key = ("dogleg_direction", str(mode), "0", "0", "0")
            for iters in (24, 128):
                if mode == 0:
                    name = "dogleg_direction"
                    args = (4096, D, iters, ctypes.c_float(1e-8), p(g), p(B),
                            p(plin), p(mask), p(delta), p(o[0]), p(o[1]),
                            p(o[2]))
                    fa, fb = (lib_a.dogleg_direction_launch,
                              lib_b.dogleg_direction_launch)
                else:
                    name = "pcg_direction"
                    args = (4096, D, iters, p(g), p(B), p(plin), p(o[1]),
                            p(ok))
                    fa, fb = (lib_a.pcg_direction_launch,
                              lib_b.pcg_direction_launch)
                a, b = _ab_pairs(cs, {"A": lambda: fa(*args, stream),
                                      "B": lambda: fb(*args, stream)},
                                 pairs, 5)
                _ab_line(f"{name}@D{D},{iters}it", a, b, pairs,
                         f"; A: {res(key, res_a)}, {smem.value} B shared "
                         f"memory, {threads.value} threads, {blocks} blocks an "
                         f"SM; B: {res(key, res_b)}")
        del g, B, plin, mask, delta, o
        torch.cuda.empty_cache()


def fk_frames(frames_a_block=(1, 2, 3, 4)):
    """Device ms of each fk_smalls instantiation (bench, DMPL and face
    problems) at F = 4096, 2048, 512, 128, with each frames-a-block choice
    forced, beside the one `fk_frames_per_block` makes: the measurement
    behind that rule."""
    import torch
    cs, _, _ = _setup(REPO, 8)
    from moshpp_torch import kernels
    from moshpp_torch.ops import marker_jac as mj
    print(cs.card_line())
    rule = mj.fk_frames_per_block
    for problem in ("bench", "dmpl", "face"):
        bp = getattr(cs, f"{problem}_problem")(4096, "cuda")
        t = bp["prob"].tables
        theta, _, extra = mj.kernel_inputs(bp["prob"].sub_model, t,
                                           bp["x_true"])
        jshift = mj.extra_shifts(t, extra)[0] if t.route == "tiled" else None
        for with_jac in (True, False):
            name = mj._names(with_jac, t.route)[0]
            for F in (4096, 2048, 512, 128):
                th = theta[:F]
                if jshift is not None:
                    js = jshift[:F]
                    fn = lambda: mj.fk_smalls_tiled(th, js, t, with_jac)
                else:
                    ex = None if extra is None else extra[:F]
                    fn = lambda: mj.fk_smalls(th, t, with_jac, ex)
                times = []
                try:
                    for nf in frames_a_block:
                        mj.fk_frames_per_block = lambda *a, nf=nf: nf
                        times.append(f"{nf}: {cs.cuda_ms(fn, n=20, hold=True):.4f}")
                finally:
                    mj.fk_frames_per_block = rule
                pick = rule(F, kernels.sm_count(th.device), with_jac, t.route)
                print(f"{name}@F={F} device ms at frames a block "
                      f"{', '.join(times)}; the rule takes {pick}", flush=True)
        del bp
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4096)
    ap.add_argument("--ab", metavar="OTHER_CHECKOUT")
    ap.add_argument("--kernel-ab", metavar="OTHER_CHECKOUT")
    ap.add_argument("--fk-frames", action="store_true",
                    help="time fk_smalls at each frames-a-block choice")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--problem", choices=("bench", "dmpl", "face", "horse",
                                          "dog", "object", "stagei"),
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
    elif a.fk_frames:
        fk_frames()
    elif a.problem == "stagei":
        profile_stagei()
    else:
        profile(a.frames, a.problem, a.fold)


if __name__ == "__main__":
    main()
