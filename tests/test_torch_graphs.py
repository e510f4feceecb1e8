"""The stage-ii dogleg iteration as CUDA graphs (`solver/graphs.py`).

On the CPU: the launch counters' bookkeeping around a capture and its
replays, on a stand-in graph; the static buffers' capacities; the whole
flow of a stage (eager at a key met first, captured at the second
iteration, replayed after, inputs loaded and the state copied out) under
an emulated graph whose capture runs nothing and whose replay runs the
recorded iteration, bit for bit against the eager loop; a CPU
`mosh_stageii_solve`, which engages no graph; and the graphs kept with
the problem under emulated graphs: a second capture of one length only
replays, another prior, options value, length or thread gets graphs of
its own, the cache goes with the problem, and the key cap drops the
least recently used; and the kept system built with TF32 off whatever
the caller set.

On the card (`cuda` marker; this file imports no JAX, and its golden
problem is built with the JAX package inside a fixture that only the CPU
tests use):

    python -m pytest --noconftest -o addopts="" tests/test_torch_graphs.py -q -m cuda

the graphs against the eager loop (`batched_system_solve_traced`) at F=256
and F=64 on the SMPL+H and the SMPL-X face (E=80, tiled route) problems of
chip_smoke.py, bit for bit with the same launch counts; and whole solves,
compaction on, against the eager schedule, on every problem family the
card runs: SMPL+H, the SMPL-X face, DMPL (the `<jac,ext>` route and the
extra anchor's aux), the horse's callable prior, the dog's GMM over
gathered dofs and the rigid object (D=6); and a chunked solve, and the
same solve resumed from its checkpoints with one chunk missing, the
chunks sharing their graphs; two captures solved on one problem, the
second only replayed; and TF32 turned on by the caller before a GMM
problem's first solve, which changes neither that solve nor the next.
"""

import collections
import contextlib
import dataclasses
import gc
import os
import sys
import threading
import weakref

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from moshpp_torch import kernels  # noqa: E402
from moshpp_torch.pipeline import stageii  # noqa: E402
from moshpp_torch.solver import gauss_newton as gn  # noqa: E402
from moshpp_torch.solver import graphs  # noqa: E402


# the counters that only a solve with graphs adds
GRAPH_KEYS = (graphs.GRAPH_COUNTER, graphs.CAPTURE_COUNTER)


def _frames_without_graphs(frames):
    return {k: n for k, n in frames.items() if k[0] not in GRAPH_KEYS}


def _rows(frames, name):
    """Sum of K x n over (name, K)."""
    return sum(K * n for (k, K), n in frames.items() if k == name)


class StandIn:
    """A graph that counts its replays."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def _region():
    kernels.count_launch("k", 8)
    kernels.count_launch("k", 8)
    kernels.count_launch("j")
    kernels.count_frames("dogleg_direction<cg=24>", 8)


def test_capture_adds_nothing_and_each_replay_adds_its_counts():
    kernels.COUNTS.reset()
    kernels.count_launch("k", 8)
    before = kernels.COUNTS.copy()
    g = graphs.CountedGraph(StandIn())
    g.capture(_region, contextlib.nullcontext())
    assert dict(g.counts.launches) == {"k": 2, "j": 1}
    assert dict(g.counts.frames) == {("k", 8): 2,
                                     ("dogleg_direction<cg=24>", 8): 1}
    assert not g.counts.plain_cuda
    # the capture ran nothing: the totals are as before it, no key added
    for now, then in zip(kernels.COUNTS._fields(), before._fields()):
        assert now == then
    assert ("dogleg_direction<cg=24>", 8) not in kernels.COUNTS.frames
    for n in range(1, 4):
        g.replay()
        assert g.graph.replays == n
        assert kernels.COUNTS.launches == collections.Counter(
            {"k": 1 + 2 * n, "j": n})
        assert kernels.COUNTS.frames == collections.Counter(
            {("k", 8): 1 + 2 * n, ("dogleg_direction<cg=24>", 8): n})
    kernels.COUNTS.reset()


def test_a_failed_capture_leaves_the_counts():
    kernels.COUNTS.reset()

    def broken():
        _region()
        raise RuntimeError("capture failed")

    g = graphs.CountedGraph(StandIn())
    with pytest.raises(RuntimeError):
        g.capture(broken, contextlib.nullcontext())
    assert not any(kernels.COUNTS._fields())


def test_buffers_by_capacity():
    cache = graphs.IterationGraphs()
    state = gn._init_state(torch.zeros(8, 5), torch.zeros(8),
                           gn.DoglegOptions())
    aux = {"a": torch.zeros(8, 2, 3)}
    mask = torch.ones(8, 5)
    sig = graphs._signature(state, aux, mask)
    small = cache._buffers_for(sig, 8, state, aux, mask)
    assert cache._buffers_for(sig, 6, state, aux, mask) is small
    big = cache._buffers_for(sig, 20, state, aux, mask)
    assert big is not small and big.capacity == 20
    assert cache._buffers_for(sig, 8, state, aux, mask) is small
    assert cache._buffers_for(sig, 9, state, aux, mask) is big
    st, ax, mk = big.views(9)
    assert st.x.shape == (9, 5) and st.it.dtype == torch.int32
    assert ax["a"].shape == (9, 2, 3) and mk.shape == (9, 5)
    assert st.x.data_ptr() == big.state.x.data_ptr() and st.x.is_contiguous()
    cache.clear()
    assert not cache._buffers


class Replayer:
    """An emulated graph: its replay runs the recorded region."""

    def __init__(self):
        self.region = None
        self.replays = 0

    def replay(self):
        self.replays += 1
        self.region()


class EmulatedGraphs(graphs.IterationGraphs):
    """`IterationGraphs` on the CPU: a capture runs the region (so that the
    counts are taken) and then puts every buffer back as it was, as if it
    had run nothing; a replay runs the region."""

    def __init__(self):
        super().__init__()
        self.captures = 0

    def engages(self, state, aux):
        return True

    def _new_graph(self):
        return Replayer()

    @contextlib.contextmanager
    def _recording(self, graph, device):
        bufs = [b for sets in self._buffers.values() for b in sets]
        held = [t for b in bufs for t in (*b.state, *b.aux.values(), b.mask,
                                          b.e_3, b.count)]
        saved = [t.clone() for t in held]
        yield
        for t, s in zip(held, saved):
            t.copy_(s)

    def _capture(self, key, region, *args):
        g = super()._capture(key, region, *args)
        g.graph.region = region
        self.captures += 1
        return g


def _toy_system():
    """r = [x - t, 0.5 x0^2] a frame, through the residual route."""
    return gn._residual_system(
        lambda x, a: torch.cat([x - a["t"], 0.5 * x[:1] ** 2]),
        batched_aux=True)


def test_emulated_graphs_match_the_eager_loop_bit_for_bit():
    N = 64
    t = torch.as_tensor(np.random.default_rng(3).normal(size=(N, 3))
                        .astype(np.float32) * np.linspace(0.1, 3, N)[:, None]
                        .astype(np.float32))
    system = _toy_system()
    dl = gn.DoglegOptions(maxiter=30, e_3=1e-6, delta_0=1.0,
                          linear_solver="pcg", cg_iters=8)
    runs = {}
    for name, cache in (("eager", None), ("graphs", EmulatedGraphs())):
        kernels.COUNTS.reset()
        with gn.fp32_matmul():
            for phase in range(2):          # the second meets every key
                res = gn.batched_system_solve(
                    system, torch.zeros(N, 3), {"t": t * (1 + phase)}, dl,
                    compact_buckets=(2, 8), _graphs=cache)
                runs[name, phase] = res
        runs[name] = dict(kernels.COUNTS.frames), cache
    kernels.COUNTS.reset()
    for phase in range(2):
        a, b = runs["eager", phase], runs["graphs", phase]
        for f in ("x", "cost", "iterations", "converged"):
            assert torch.equal(getattr(a, f), getattr(b, f)), (phase, f)
        assert a.host_syncs == b.host_syncs
    eager, _ = runs["eager"]
    frames, cache = runs["graphs"]
    replayed = {K: n for (k, K), n in frames.items() if k == "gn.graph"}
    captured = {K: n for (k, K), n in frames.items() if k == "gn.capture"}
    assert _frames_without_graphs(frames) == eager
    steps = {K: n for (k, K), n in eager.items() if k == "gn.step"}
    # one key a batch; each met first eagerly, captured once
    assert len(cache) == len(steps) == cache.captures
    assert sum(captured.values()) == cache.captures
    assert set(replayed) <= set(steps)
    for K, n in steps.items():          # all but the first at each key
        assert replayed.get(K, 0) == n - 1, K
    # the compaction buckets share the full batch's buffers
    assert [b.capacity for sets in cache._buffers.values()
            for b in sets] == [N]


@pytest.fixture(scope="module")
def golden():
    """The port's golden SMPL+H problem tiled to 64 noisy frames, so that
    the phases compact their stragglers: (problem, options, prior, obs,
    mask)."""
    from golden_common import build_family_problem
    from torch_families_common import port_problem
    fp = dict(build_family_problem("smplh"), family="smplh")
    prob, opts, prior = port_problem(fp)
    obs, mask = np.array(fp["obs"]), np.array(fp["mask"])
    reps = 64 // obs.shape[0]
    noisy = np.tile(obs, (reps, 1, 1)) + np.random.default_rng(0).normal(
        size=(reps * obs.shape[0],) + obs.shape[1:]).astype(np.float32) * 3e-3
    return prob, opts, prior, noisy.astype(np.float32), np.tile(mask,
                                                                (reps, 1))


def _fresh(golden):
    """`golden` with a problem of its own, which holds no graphs yet."""
    return (dataclasses.replace(golden[0]),) + tuple(golden[1:])


def _other_capture(golden):
    """A second capture of the golden frames' length: other noise."""
    obs = golden[3] + np.random.default_rng(1).normal(
        size=golden[3].shape).astype(np.float32) * 2e-3
    return obs.astype(np.float32)


def _recording_solves(monkeypatch, drop_cache=False):
    """Patch the schedule's solver to record each call's cache (and, with
    `drop_cache`, to hand it none): the list of caches."""
    real = stageii.batched_system_solve
    seen = []

    def recording(*args, _graphs=None, **kwargs):
        seen.append(_graphs)
        return real(*args, _graphs=None if drop_cache else _graphs, **kwargs)

    monkeypatch.setattr(stageii, "batched_system_solve", recording)
    return seen


def _emulate(monkeypatch):
    """Make the schedule's caches `EmulatedGraphs`: the list of those
    made."""
    made = []

    def emulated():
        made.append(EmulatedGraphs())
        return made[-1]

    monkeypatch.setattr(stageii, "IterationGraphs", emulated)
    return made


def _solve_counted(golden, **change):
    """One CPU solve of `golden` with the fields named in `change` (prob,
    opts, prior, obs, mask) replaced: (result, the counters' frames)."""
    g = dict(zip(("prob", "opts", "prior", "obs", "mask"), golden), **change)
    kernels.COUNTS.reset()
    res = stageii.mosh_stageii_solve(g["prob"], g["opts"], g["obs"],
                                     g["mask"], prior=g["prior"],
                                     model_type="smplh", device="cpu")
    frames = dict(kernels.COUNTS.frames)
    kernels.COUNTS.reset()
    return res, frames


def _assert_same(a, b, syncs=True):
    """The results equal bit for bit (and their host syncs, with
    `syncs`)."""
    if syncs:
        assert a.host_syncs == b.host_syncs
    for f in stageii.StageIIResult._fields[:-1]:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f


def _captures(frames) -> int:
    return sum(n for (k, _), n in frames.items()
               if k == graphs.CAPTURE_COUNTER)


def test_cpu_solve_engages_no_graph_and_drops_its_cache(golden, monkeypatch):
    """A CPU solve engages no graph; its cache, empty, is kept with the
    problem for the next solve and goes when the problem goes."""
    g = _fresh(golden)
    seen = _recording_solves(monkeypatch)
    res, frames = _solve_counted(g)
    # one cache for the call, shared by its eight phases, empty
    assert len(seen) == 8 and len(set(map(id, seen))) == 1
    assert seen[0] is not None
    assert len(seen[0]) == 0 and not seen[0]._buffers
    assert not any(k in GRAPH_KEYS for k, _ in frames)
    first = weakref.ref(seen[0])
    seen.clear()
    again, _ = _solve_counted(g)
    assert seen[0] is first() and len(seen[0]) == 0
    _assert_same(res, again)
    seen.clear()
    del g
    assert first() is None
    # and the same solve handed no cache at all
    monkeypatch.undo()
    _recording_solves(monkeypatch, drop_cache=True)
    bare, bare_frames = _solve_counted(golden)
    _assert_same(res, bare)
    assert frames == bare_frames


def test_emulated_graphs_in_a_whole_solve(golden, monkeypatch):
    """The schedule's phases, the polish's PCG among them, through
    emulated graphs: bit for bit the eager solve, the same counters but
    ("gn.graph", K) and ("gn.capture", K); the graphs and their buffers
    kept with the problem when the call returns, and gone with it."""
    opts = dataclasses.replace(golden[1], polish_solver="pcg")
    g = _fresh(golden)
    _recording_solves(monkeypatch, drop_cache=True)
    eager, eager_frames = _solve_counted(g, opts=opts)
    monkeypatch.undo()
    made = _emulate(monkeypatch)
    g = _fresh(golden)
    res, frames = _solve_counted(g, opts=opts)
    _assert_same(eager, res)
    replayed = _rows(frames, "gn.graph")
    rows = _rows(frames, "gn.step")
    assert _frames_without_graphs(frames) == eager_frames
    assert 0.5 * rows < replayed < rows
    assert len(made) == 1 and made[0].captures > 0
    assert _captures(frames) == made[0].captures
    assert len(made[0]) >= made[0].captures and made[0]._buffers
    assert [e[1] for e in g[0]._solvers.values()] == made
    gone = weakref.ref(made.pop())
    del g
    gc.collect()        # an emulated graph's region refers to its cache
    assert gone() is None


def test_a_second_capture_on_one_problem_only_replays(golden, monkeypatch):
    """Two captures of one length solved on one problem through emulated
    graphs: each bit for bit its eager solve with the same counters; the
    second captures nothing and runs no iteration eagerly."""
    opts = dataclasses.replace(golden[1], polish_solver="pcg")
    captures = (golden[3], _other_capture(golden))
    g = _fresh(golden)
    _recording_solves(monkeypatch, drop_cache=True)
    eager = [_solve_counted(g, opts=opts, obs=o) for o in captures]
    monkeypatch.undo()
    made = _emulate(monkeypatch)
    g = _fresh(golden)
    runs = [_solve_counted(g, opts=opts, obs=o) for o in captures]
    for (e, e_frames), (r, r_frames) in zip(eager, runs):
        _assert_same(e, r)
        assert _frames_without_graphs(r_frames) == e_frames
    (_, first), (_, second) = runs
    assert len(made) == 1 and _captures(first) == made[0].captures > 0
    # the counter is there, at zero
    assert any(k == graphs.CAPTURE_COUNTER for k, _ in second)
    assert _captures(second) == 0
    assert _rows(second, "gn.graph") == _rows(second, "gn.step") > 0


@pytest.mark.parametrize("change", ["prior", "options", "equal_options",
                                    "length", "thread"])
def test_what_gets_graphs_of_its_own(golden, monkeypatch, change):
    """A solve after a first on one problem: another prior (an equal copy),
    another options value or another host thread gets a cache of its own;
    an equal options value (a new object) shares the first's and replays
    only; another length shares it and captures its own keys."""
    made = _emulate(monkeypatch)
    g = _fresh(golden)
    first, _ = _solve_counted(g)
    second = dict(prior=stageii._replicate(g[2], "cpu"),
                  options=dict(opts=dataclasses.replace(g[1], cg_iters=20)),
                  equal_options=dict(opts=dataclasses.replace(
                      g[1], weights=dict(g[1].weights or {}))),
                  length=dict(obs=g[3][:56], mask=g[4][:56]),
                  thread={})[change]
    if change == "prior":
        assert second is not g[2]
        second = dict(prior=second)
    out = []
    if change == "thread":
        t = threading.Thread(target=lambda: out.append(_solve_counted(g)))
        t.start()
        t.join(timeout=600)
        assert not t.is_alive()
    else:
        out.append(_solve_counted(g, **second))
    res, frames = out[0]
    own = change in ("prior", "options", "thread")
    assert len(made) == (2 if own else 1)
    assert len(g[0]._solvers) == len(made)
    if change == "equal_options":
        assert _captures(frames) == 0
    else:
        assert _captures(frames) > 0
    if change in ("prior", "equal_options", "thread"):
        _assert_same(first, res)


def _toy_solve(system, cache, N, dl):
    """A toy solve of N frames, no compaction: (result, counters'
    frames)."""
    t = torch.linspace(-2.0, 3.0, 3 * N).reshape(N, 3)
    kernels.COUNTS.reset()
    with gn.fp32_matmul():
        res = gn.batched_system_solve(system, torch.zeros(N, 3), {"t": t},
                                      dl, compact_buckets=(), _graphs=cache)
    frames = dict(kernels.COUNTS.frames)
    kernels.COUNTS.reset()
    return res, frames


def test_the_key_cap_drops_the_least_recently_used():
    """At most `max_keys` keys: a new one drops the least recently used,
    and the buffers no graph left reads; a key met again after it went is
    run eagerly and captured anew; every solve bit for bit the eager
    loop's."""
    system = _toy_system()
    dl = gn.DoglegOptions(maxiter=30, e_3=1e-6, delta_0=1.0,
                          linear_solver="pcg", cg_iters=8)
    cache = EmulatedGraphs()
    cache.max_keys = 2

    def solve(N):
        res, frames = _toy_solve(system, cache, N, dl)
        eager, eager_frames = _toy_solve(system, None, N, dl)
        for f in ("x", "cost", "iterations", "converged"):
            assert torch.equal(getattr(res, f), getattr(eager, f)), (N, f)
        assert _frames_without_graphs(frames) == eager_frames
        return frames

    def held():
        return [key[1] for key in cache._graphs]

    def capacities():
        return sorted(b.capacity for sets in cache._buffers.values()
                      for b in sets)

    for N in (16, 24, 32):
        assert _captures(solve(N)) == 1
    assert held() == [24, 32] and capacities() == [24, 32]
    # 16 again: met anew, which drops 24 and its buffers; captured on the
    # 32-frame buffers
    frames = solve(16)
    assert _captures(frames) == 1
    assert frames[("gn.step", 16)] - frames[("gn.graph", 16)] == 1
    assert held() == [32, 16] and capacities() == [32]
    # 32 replays only and is used last: 24 drops 16, the least recent
    frames = solve(32)
    assert _captures(frames) == 0
    assert frames[("gn.step", 32)] == frames[("gn.graph", 32)]
    assert held() == [16, 32]
    solve(24)
    assert held() == [32, 24] and capacities() == [32]
    assert cache.captures == 5


@contextlib.contextmanager
def _tf32_turned_on(how):
    """TF32 turned on for the process the way a caller does (`how`), the
    flags put back after: the flags as read inside."""
    saved = _tf32_flags()
    try:
        if how == "allow_tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        else:
            torch.set_float32_matmul_precision("high")
        yield _tf32_flags()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _tf32_flags():
    """(cuBLAS's, cuDNN's) TF32 flags."""
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


@pytest.mark.parametrize("how", ["allow_tf32", "matmul_precision"])
def test_the_kept_system_is_built_with_tf32_off(golden, monkeypatch, how):
    """A caller turns TF32 on before a problem's first solve: the system
    the problem keeps for its later solves is built under the solve's
    full-float32 products, and the caller's setting is back when the solve
    returns."""
    real = stageii.make_stageii_system
    seen = []

    def recording(*args, **kwargs):
        seen.append(_tf32_flags())
        return real(*args, **kwargs)

    monkeypatch.setattr(stageii, "make_stageii_system", recording)
    g = _fresh(golden)
    with _tf32_turned_on(how) as on:
        assert on[0]
        _solve_counted(g)
        assert _tf32_flags() == on
    assert seen == [(False, False)]
    assert len(g[0]._solvers) == 1


# ---- on the card --------------------------------------------------------


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _chip_problem(name, frames):
    sys.path.insert(0, REPO)
    import chip_smoke
    return getattr(chip_smoke, name)(frames, "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("frames", [256, 64])
@pytest.mark.parametrize("problem", ["bench_problem", "face_problem"])
def test_graphs_match_the_eager_loop_on_the_card(dev, problem, frames):
    """`batched_system_solve` with a cache and no compaction against the
    eager loops, the plain one and the traced one that runs every
    iteration (`batched_system_solve_traced`): x, cost, iterations and
    converged bit for bit; the launches and counters equal the plain
    loop's; every iteration but the first replayed."""
    import chip_smoke
    bp = _chip_problem(problem, frames)
    system, x0, aux, dl = chip_smoke.traced_phase(bp, maxiter=40)
    _, step2 = stageii._param_masks(bp["prob"].sub_model, bp["opts"],
                                    bp["model_type"], dev)
    runs = {}
    for name, cache in (("eager", None), ("graphs", graphs.IterationGraphs())):
        kernels.COUNTS.reset()
        with gn.fp32_matmul():
            r = gn.batched_system_solve(system, x0, aux, dl, param_mask=step2,
                                        e_3=1e-4, compact_buckets=(),
                                        _graphs=cache)
        torch.cuda.synchronize()
        runs[name] = (r, kernels.COUNTS.copy(), cache)
    traced, _ = gn.batched_system_solve_traced(system, x0, aux, dl,
                                               param_mask=step2, e_3=1e-4)
    torch.cuda.synchronize()
    kernels.COUNTS.reset()
    (eager, ce, _), (graph, cg, cache) = runs["eager"], runs["graphs"]
    for f in ("x", "cost", "iterations", "converged"):
        assert torch.equal(getattr(graph, f), getattr(traced, f)), f
        assert torch.equal(getattr(graph, f), getattr(eager, f)), f
    assert graph.host_syncs == eager.host_syncs
    assert cg.launches == ce.launches
    assert _frames_without_graphs(cg.frames) == dict(ce.frames)
    steps = ce.frames[("gn.step", frames)]
    assert cg.frames[("gn.graph", frames)] == steps - 1
    assert len(cache) == 1


def _card_solve(bp, opts, eager, monkeypatch, obs=None):
    if eager:
        _recording_solves(monkeypatch, drop_cache=True)
    kernels.COUNTS.reset()
    res = stageii.mosh_stageii_solve(
        bp["prob"], opts, bp["obs"] if obs is None else obs, bp["mask"],
        prior=bp["prior"], model_type=bp["model_type"], device="cuda")
    torch.cuda.synchronize()
    counts = kernels.COUNTS.copy()
    kernels.COUNTS.reset()
    monkeypatch.undo()
    return res, counts


def _assert_replayed(counts, eager_counts):
    """The launches and counters of a solve with graphs equal the eager
    solve's, but ("gn.graph", K) and ("gn.capture", K); most rows
    replayed."""
    assert counts.launches == eager_counts.launches
    assert _frames_without_graphs(counts.frames) == dict(eager_counts.frames)
    assert _rows(counts.frames, "gn.graph") > 0.5 * _rows(counts.frames,
                                                          "gn.step")


@pytest.mark.cuda
@pytest.mark.parametrize("problem,frames", [("bench_problem", 512),
                                            ("face_problem", 256),
                                            ("dmpl_problem", 256),
                                            ("horse_problem", 256),
                                            ("dog_problem", 256),
                                            ("object_problem", 256)])
def test_whole_solve_matches_the_eager_schedule_on_the_card(
        dev, monkeypatch, problem, frames):
    """One `mosh_stageii_solve` with compaction, graphs against the eager
    schedule (the parent's path): outputs bit for bit; the host syncs,
    launches and counters equal; most rows replayed."""
    bp = _chip_problem(problem, frames)
    eager, ce = _card_solve(bp, bp["opts"], True, monkeypatch)
    res, cg = _card_solve(bp, bp["opts"], False, monkeypatch)
    _assert_same(eager, res)
    _assert_replayed(cg, ce)


def _eager_steps(frames) -> int:
    """The iterations that ran eagerly: ("gn.step", K) less ("gn.graph",
    K), summed over K."""
    return sum(n - frames.get((graphs.GRAPH_COUNTER, K), 0)
               for (k, K), n in frames.items() if k == "gn.step")


@pytest.mark.cuda
@pytest.mark.parametrize("problem,frames,recurs", [
    ("bench_problem", 512, True), ("face_problem", 256, True),
    # the reversed capture runs batch shapes the first did not capture
    ("horse_problem", 256, False)])
def test_a_second_capture_on_one_problem_only_replays_on_the_card(
        dev, monkeypatch, problem, frames, recurs):
    """Two captures of one length (the second the first run backwards)
    solved on one problem, graphs against the eager schedule: each bit
    for bit, with equal syncs, launches and counters. The second replays
    every graph the first captured and captures none again: it runs
    eagerly only the keys it meets first and captures only those the
    first left uncaptured; where its keys recur it only replays."""
    bp = _chip_problem(problem, frames)
    captures = (bp["obs"], bp["obs"].flip(0).contiguous())
    eager = [_card_solve(bp, bp["opts"], True, monkeypatch, obs=o)
             for o in captures]
    bp["prob"] = dataclasses.replace(bp["prob"])     # no graphs kept yet
    res, c1 = _card_solve(bp, bp["opts"], False, monkeypatch, obs=captures[0])
    (_, cache), = bp["prob"]._solvers.values()
    kept = dict(cache._graphs)
    res2, c2 = _card_solve(bp, bp["opts"], False, monkeypatch,
                           obs=captures[1])
    for (e, ce), (r, cr) in zip(eager, ((res, c1), (res2, c2))):
        _assert_same(e, r)
        _assert_replayed(cr, ce)
    first, second = c1.frames, c2.frames
    assert _captures(first) > 0
    for key, graph in kept.items():
        if graph is not None:
            assert cache._graphs[key] is graph
    new = [k for k in cache._graphs if k not in kept]
    assert _eager_steps(second) == len(new)
    assert _captures(second) == sum(
        g is not None and kept.get(k) is None for k, g in cache._graphs.items())
    if recurs:
        assert _captures(second) == 0 and not new
        assert _rows(second, "gn.graph") == _rows(second, "gn.step")


@pytest.mark.cuda
def test_chunked_and_resumed_solves_match_the_eager_schedule_on_the_card(
        dev, monkeypatch, tmp_path):
    """A solve of 640 frames in three chunks of 256, graphs against the
    eager schedule: bit for bit, equal syncs, launches and counters, the
    chunks sharing one problem's graphs (one eager iteration and at most
    one capture a key over the three); then the same solve resumed from
    its checkpoints with the middle chunk's removed, which solves that
    chunk alone, replaying only: bit for bit again."""
    bp = _chip_problem("bench_problem", 640)
    opts = dataclasses.replace(bp["opts"], chunk_frames=256, chunk_halo=32)
    eager, ce = _card_solve(bp, opts, True, monkeypatch)
    kept = dataclasses.replace(opts, checkpoint_dir=str(tmp_path))
    res, cg = _card_solve(bp, kept, False, monkeypatch)
    _assert_same(eager, res)
    _assert_replayed(cg, ce)
    keys = sum(len(e[1]) for e in bp["prob"]._solvers.values())
    assert _eager_steps(cg.frames) == keys
    assert 0 < _captures(cg.frames) <= keys
    os.remove(tmp_path / "chunk_000000256.npz")
    resumed, cr = _card_solve(bp, kept, False, monkeypatch)
    assert 0 < resumed.host_syncs < eager.host_syncs
    assert _captures(cr.frames) == 0 and _eager_steps(cr.frames) == 0
    assert _rows(cr.frames, "gn.graph") > 0
    _assert_same(eager, resumed, syncs=False)


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["allow_tf32", "matmul_precision"])
def test_tf32_turned_on_before_the_first_solve_on_the_card(
        dev, monkeypatch, how):
    """TF32 turned on for the process before the first solve of a GMM
    problem (its prior's precision blocks are a cuBLAS bmm): the system the
    problem keeps is built with TF32 off, and that solve, and the next with
    TF32 off again, which runs on the system and graphs the first kept,
    equal bit for bit the solves of a problem whose first solve ran with
    TF32 off."""
    from moshpp_torch.priors.gmm import MaxMixturePrior
    bp = _chip_problem("bench_problem", 256)
    assert isinstance(bp["prior"], MaxMixturePrior)
    real, seen = stageii.make_stageii_system, []

    def recording(*args, **kwargs):
        seen.append(_tf32_flags())
        return real(*args, **kwargs)

    clean = dataclasses.replace(bp["prob"])
    stageii.make_stageii_system = recording
    try:
        ref = [_card_solve(dict(bp, prob=clean), bp["opts"], False,
                           monkeypatch)[0] for _ in range(2)]
        with _tf32_turned_on(how) as on:
            assert on[0]
            first, _ = _card_solve(bp, bp["opts"], False, monkeypatch)
        second, _ = _card_solve(bp, bp["opts"], False, monkeypatch)
    finally:
        stageii.make_stageii_system = real
    assert seen == [(False, False)] * 2
    _assert_same(ref[0], first)
    _assert_same(ref[1], second)
