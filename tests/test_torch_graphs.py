"""The stage-ii dogleg iteration as CUDA graphs (`solver/graphs.py`).

On the CPU: the launch counters' bookkeeping around a capture and its
replays, on a stand-in graph; the static buffers' capacities; the whole
flow of a stage (eager at a key met first, captured at the second
iteration, replayed after, inputs loaded and the state copied out) under
an emulated graph whose capture runs nothing and whose replay runs the
recorded iteration, bit for bit against the eager loop; and a CPU
`mosh_stageii_solve`, which engages no graph and drops its cache.

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
same solve resumed from its checkpoints with one chunk missing.
"""

import collections
import contextlib
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from moshpp_torch import kernels  # noqa: E402
from moshpp_torch.pipeline import stageii  # noqa: E402
from moshpp_torch.solver import gauss_newton as gn  # noqa: E402
from moshpp_torch.solver import graphs  # noqa: E402


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

    def _capture(self, key, region, device):
        g = super()._capture(key, region, device)
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
    rest = {k: n for k, n in frames.items() if k[0] != "gn.graph"}
    assert rest == eager
    steps = {K: n for (k, K), n in eager.items() if k == "gn.step"}
    # one key a batch; each met first eagerly, captured once
    assert len(cache) == len(steps) == cache.captures
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


def _solve_counted(golden, opts=None):
    prob, opts0, prior, obs, mask = golden
    kernels.COUNTS.reset()
    res = stageii.mosh_stageii_solve(prob, opts or opts0, obs, mask,
                                     prior=prior, model_type="smplh",
                                     device="cpu")
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


def test_cpu_solve_engages_no_graph_and_drops_its_cache(golden, monkeypatch):
    seen = _recording_solves(monkeypatch)
    res, frames = _solve_counted(golden)
    caches = set(map(id, seen))
    # one cache for the call, shared by its eight phases, empty at the end
    assert len(seen) == 8 and len(caches) == 1 and seen[0] is not None
    assert len(seen[0]) == 0 and not seen[0]._buffers
    assert not any(k == "gn.graph" for k, _ in frames)
    first = seen[0]
    seen.clear()
    again, _ = _solve_counted(golden)
    assert seen[0] is not first
    _assert_same(res, again)
    # and the same solve handed no cache at all
    monkeypatch.undo()
    _recording_solves(monkeypatch, drop_cache=True)
    bare, bare_frames = _solve_counted(golden)
    _assert_same(res, bare)
    assert frames == bare_frames


def test_emulated_graphs_in_a_whole_solve(golden, monkeypatch):
    """The schedule's phases, the polish's PCG among them, through
    emulated graphs: bit for bit the eager solve, the same counters but
    ("gn.graph", K), and the cache empty when the call returns."""
    import dataclasses
    opts = dataclasses.replace(golden[1], polish_solver="pcg")
    made = []

    def emulated():
        made.append(EmulatedGraphs())
        return made[-1]

    _recording_solves(monkeypatch, drop_cache=True)
    eager, eager_frames = _solve_counted(golden, opts)
    monkeypatch.undo()
    monkeypatch.setattr(stageii, "IterationGraphs", emulated)
    res, frames = _solve_counted(golden, opts)
    _assert_same(eager, res)
    replayed = sum(K * n for (k, K), n in frames.items() if k == "gn.graph")
    rows = sum(K * n for (k, K), n in frames.items() if k == "gn.step")
    assert {k: n for k, n in frames.items() if k[0] != "gn.graph"} \
        == eager_frames
    assert 0.5 * rows < replayed < rows
    assert len(made) == 1 and made[0].captures > 0
    assert len(made[0]) == 0 and not made[0]._buffers


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


def _frames_without_graphs(frames):
    return {k: n for k, n in frames.items() if k[0] != "gn.graph"}


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


def _card_solve(bp, opts, eager, monkeypatch):
    if eager:
        _recording_solves(monkeypatch, drop_cache=True)
    kernels.COUNTS.reset()
    res = stageii.mosh_stageii_solve(
        bp["prob"], opts, bp["obs"], bp["mask"], prior=bp["prior"],
        model_type=bp["model_type"], device="cuda")
    torch.cuda.synchronize()
    counts = kernels.COUNTS.copy()
    kernels.COUNTS.reset()
    monkeypatch.undo()
    return res, counts


def _assert_replayed(counts, eager_counts):
    """The launches and counters of a solve with graphs equal the eager
    solve's, but ("gn.graph", K); most rows replayed."""
    assert counts.launches == eager_counts.launches
    assert _frames_without_graphs(counts.frames) == dict(eager_counts.frames)
    replayed = sum(K * n for (k, K), n in counts.frames.items()
                   if k == "gn.graph")
    rows = sum(K * n for (k, K), n in counts.frames.items()
               if k == "gn.step")
    assert replayed > 0.5 * rows


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


@pytest.mark.cuda
def test_chunked_and_resumed_solves_match_the_eager_schedule_on_the_card(
        dev, monkeypatch, tmp_path):
    """A solve of 640 frames in three chunks of 256 (each chunk's inner
    call makes its own graphs), graphs against the eager schedule: bit
    for bit, equal syncs, launches and counters; then the same solve
    resumed from its checkpoints with the middle chunk's removed, which
    solves that chunk alone: bit for bit again."""
    import dataclasses
    bp = _chip_problem("bench_problem", 640)
    opts = dataclasses.replace(bp["opts"], chunk_frames=256, chunk_halo=32)
    eager, ce = _card_solve(bp, opts, True, monkeypatch)
    kept = dataclasses.replace(opts, checkpoint_dir=str(tmp_path))
    res, cg = _card_solve(bp, kept, False, monkeypatch)
    _assert_same(eager, res)
    _assert_replayed(cg, ce)
    os.remove(tmp_path / "chunk_000000256.npz")
    resumed, cr = _card_solve(bp, kept, False, monkeypatch)
    assert 0 < resumed.host_syncs < eager.host_syncs
    assert any(k == "gn.graph" for k, _ in cr.frames)
    _assert_same(eager, resumed, syncs=False)
