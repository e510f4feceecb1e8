"""The port's profiler spans and counters inside the stage-ii solve.

On the CPU: the gated span helper builds no profiler range while no
profiler records; under `torch.profiler` the golden SMPL+H solve
(tests/golden_common.py, 4 frames) opens the span tree of
`moshpp_torch/utils/spans.py`; a 64-frame solve on the same model, whose
phases compact their stragglers, counts its frame-iterations in
`kernels.COUNTS.frames`; and the profiler leaves the outputs and the host
syncs bit for bit as they are. The golden problem is built with the JAX
package inside a fixture, so that on the card, where there is no JAX, the
one test marked `cuda` runs alone:

    python -m pytest --noconftest -o addopts="" tests/test_torch_spans.py -q -m cuda
"""

import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from moshpp_torch import kernels  # noqa: E402
from moshpp_torch.pipeline import stageii  # noqa: E402
from moshpp_torch.solver import pcg  # noqa: E402
from moshpp_torch.utils import spans  # noqa: E402


@pytest.fixture(scope="module")
def golden():
    """The port's golden SMPL+H problem: (problem, options, prior, obs,
    mask)."""
    from golden_common import build_family_problem
    from torch_families_common import port_problem
    fp = dict(build_family_problem("smplh"), family="smplh")
    prob, opts, prior = port_problem(fp)
    return prob, opts, prior, np.array(fp["obs"]), np.array(fp["mask"])


def _solve(golden, obs=None, mask=None):
    prob, opts, prior, obs0, mask0 = golden
    return stageii.mosh_stageii_solve(
        prob, opts, obs0 if obs is None else obs,
        mask0 if mask is None else mask, prior=prior, model_type="smplh",
        device="cpu")


def _program_spans(prof):
    """[(name, parent program span's name or None)] of the profile's
    program spans, in the order they began."""
    out = []
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if e.name not in spans.SPANS:
            continue
        p = e.cpu_parent
        while p is not None and p.name not in spans.SPANS:
            p = p.cpu_parent
        out.append((e.name, None if p is None else p.name))
    return out


def test_span_builds_no_range_while_no_profiler_records(monkeypatch):
    built = []
    real = torch.profiler.record_function

    def counting(name):
        built.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    a, b = spans.span(spans.STEP), spans.span(spans.SOLVE)
    with a:
        pass
    assert a is b and built == []
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span(spans.STEP):
            pass
    assert built == [spans.STEP]


def test_span_table_names_every_phase_and_layer():
    assert [spans.phase(p) for p in spans.PHASES] == [
        n for n in spans.SPANS if n.startswith(spans.PHASE_PREFIX)]
    assert set(spans.SPANS.values()) == {spans.SCHEDULE, spans.SYSTEM,
                                         spans.DOGLEG, spans.STAGEI}
    # the spans the solver and stage i open are in the table
    assert {spans.FREEZE, spans.CHOLESKY, spans.JACFWD,
            spans.NORMAL_EQUATIONS, spans.CALLABLE_PRIOR} <= set(spans.SPANS)


def test_stageii_span_tree(golden):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = _solve(golden)
    got = _program_spans(prof)
    names = [n for n, _ in got]
    parent = {}
    for n, p in got:
        parent.setdefault(n, set()).add(p)
    assert names.count(spans.SOLVE) == 1 and parent[spans.SOLVE] == {None}
    # the anchor pass runs (anchor stride 2 over 4 frames), one sweep
    phases = [n[len(spans.PHASE_PREFIX):] for n in names
              if n.startswith(spans.PHASE_PREFIX)]
    assert phases == ["anneal10", "anneal5", "anneal1", "anchor_step2",
                      "step1", "step2", "sweep", "polish"]
    for n in (spans.RIGID_INIT, spans.SLERP, spans.FINALIZE,
              *[spans.phase(p) for p in set(phases)]):
        assert parent[n] == {spans.SOLVE}, n
    assert parent[spans.GN_SOLVE] == {spans.phase(p) for p in phases}
    assert names.count(spans.GN_SOLVE) == len(phases)
    assert parent[spans.VELO_AUX] == {spans.phase("sweep"),
                                      spans.phase("polish")}
    for n in (spans.STEP, spans.ACTIVE_READ):
        assert parent[n] == {spans.GN_SOLVE}, n
    for n in (spans.ASSEMBLY, spans.DIRECTION, spans.POST_STEP):
        assert parent[n] == {spans.STEP}, n
        assert names.count(n) == names.count(spans.STEP), n
    # the cost at each trial point, and once at x0 of each solve
    assert parent[spans.COST] == {spans.STEP, spans.GN_SOLVE}
    assert names.count(spans.COST) == (names.count(spans.STEP)
                                       + len(phases))
    for n in (spans.DATA_ROWS, spans.NORMAL_EQ, spans.PRIOR):
        assert parent[n] == {spans.ASSEMBLY}, n
    assert names.count(spans.ACTIVE_READ) == res.host_syncs
    assert names.count(spans.STEP) > 0


def test_report_spans(golden):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        prob, opts, prior, obs, mask = golden
        stageii.mosh_stageii_solve(prob, opts, obs, mask, prior=prior,
                                   model_type="smplh", return_report=True,
                                   device="cpu")
    got = _program_spans(prof)
    parents = {p for n, p in got if n == spans.REPORT}
    assert parents == {spans.SOLVE} | {spans.phase(p) for p in spans.PHASES}


def _compacting_problem(golden, F=64, seed=0):
    """F frames of the golden captures tiled, each moved by its own 3 mm
    noise: the frames converge at their own iterations, so the phases
    compact (buckets F/2, F/8 of the full batch; 33/2 of the anchors)."""
    obs, mask = golden[3], golden[4]
    reps = F // obs.shape[0]
    rng = np.random.default_rng(seed)
    noisy = np.tile(obs, (reps, 1, 1)) + rng.normal(
        size=(F,) + obs.shape[1:]).astype(np.float32) * 0.003
    return noisy.astype(np.float32), np.tile(mask, (reps, 1))


def test_counters_sum_the_frame_iterations(golden, monkeypatch):
    obs, mask = _compacting_problem(golden)
    iters = []
    real = stageii.batched_system_solve

    def recording(*args, **kwargs):
        r = real(*args, **kwargs)
        iters.append(int(r.iterations.to(torch.int64).sum()))
        return r

    monkeypatch.setattr(stageii, "batched_system_solve", recording)
    kernels.COUNTS.reset()
    res = _solve(golden, obs, mask)
    frames = dict(kernels.COUNTS.frames)
    kernels.COUNTS.reset()
    active = sum(n for (k, _), n in frames.items() if k == "gn.active")
    rows = sum(K * n for (k, K), n in frames.items() if k == "gn.step")
    assert len(iters) == 8 and active == sum(iters) > 0
    assert rows >= active
    steps = {K for k, K in frames if k == "gn.step"}
    # the full batch, the anchors and the compaction buckets
    assert steps >= {64, 33, 32, 16, 8}, steps
    # one read before each iteration, one more where a stage stops
    n_steps = sum(n for (k, _), n in frames.items() if k == "gn.step")
    assert n_steps < res.host_syncs


def test_profiler_leaves_outputs_and_syncs_bit_for_bit(golden):
    obs, mask = _compacting_problem(golden, seed=1)
    off = _solve(golden, obs, mask)
    with profile(activities=[ProfilerActivity.CPU]):
        on = _solve(golden, obs, mask)
    assert on.host_syncs == off.host_syncs
    for f in stageii.StageIIResult._fields[:-1]:
        a, b = getattr(off, f), getattr(on, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f


def test_direction_counter_counts_kernel_launches_only():
    """On CPU tensors the direction runs its plain version: no launch and
    no `dogleg_direction<cg=I>` count."""
    args = pcg.direction_test_system(6, 9, 1e2, device="cpu")
    kernels.COUNTS.reset()
    pcg.dogleg_direction_batched(*args, 24, 1e-8)
    assert not kernels.COUNTS.frames and not kernels.COUNTS.launches


@pytest.mark.cuda
def test_direction_counter_keys_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = pcg.direction_test_system(96, 117, 1e2, device="cuda")
    kernels.COUNTS.reset()
    for iters in (24, 128, 24):
        pcg.dogleg_direction_batched(*args, iters, 1e-8)
    torch.cuda.synchronize()
    assert dict(kernels.COUNTS.frames) == {
        ("dogleg_direction<cg=24>", 96): 2,
        ("dogleg_direction<cg=128>", 96): 1}
    assert kernels.COUNTS.launches["dogleg_direction"] == 3
    kernels.COUNTS.reset()
