"""CUDA graphs of the batched dogleg's iteration.

A stage-ii dogleg iteration launches ~160-180 small kernels through eager
PyTorch and the kernel wrappers; at the protocol's batch sizes the host
takes longer to launch them than the card to run them. `IterationGraphs`
records one iteration as a CUDA graph for each batch shape and replays it:
one `replay()` and one read of the active count an iteration. The graph
holds every kernel the eager iteration launches, the hand-written ones
included; it replaces none of them.

At a key (the batch K, the shapes and dtypes of the state, `aux` and mask,
and the caller's system and options) met for the first time the iteration
runs eagerly, which is also the warm-up a capture needs; the second
iteration at that key captures the graph and replays it; every later
iteration at that key replays. A graph reads the state, `aux`, the
parameter mask and e_3 from static buffers and writes the new state and
the next active count back into them. The buffers of one signature (the
shapes past the batch) are allocated once at the largest batch met and a
graph at K frames uses their first K rows, so the compaction buckets of a
batch, and the phases of one shape (the polish among them), share its
buffers: one set is ~2.6 KB a frame on SMPL+H (the state, the PCG warm
start, the markers, the velocity anchors, the parameter mask), 42 MB at
F=16,384, about a third of what a set a key would hold with its
buckets and the polish's. A run of iterations (a stage) copies its inputs
in before its first replay and its state out when it ends.

A capture runs nothing, and a replay runs no kernel wrapper, so the
launch counters (`kernels.COUNTS`) are kept true by hand: the counts a
capture records are taken back out and added once for every replay
(`CountedGraph`). That bookkeeping assumes no other thread counts while a
graph is captured: a solve on a mesh gets no graphs. Each stage that
replays adds one at ("gn.capture", K) where it captured its graph and
zero where it found the graph made, so that the key shows in a run that
captured nothing.

The owner keeps one `IterationGraphs` as long as the system its graphs
were captured against, whose tensors they read: the stage-ii schedule
keeps it with the subject's `StageIIProblem` (`stageii._solver`), one a
prior, options value, model type, device and host thread, so that the
solves of captures of one length after the first replay every
iteration. It holds at most `max_keys` keys and drops the least recently
used, with the buffers no graph left reads; the graphs and the buffers go
when it is cleared or dropped. The capture stream and the graphs' memory
pool outlive it: one of each a device and host thread (`capturer`), so
that every owner's captures take the pool's free blocks rather than new
device memory. The pool holds about one iteration's scratch: 1.8 GiB for
SMPL+H at F=4,096, 7.2 GiB at F=16,384. A pool for each owner would
cudaMalloc that much for every owner made, and the freed pools stay
reserved until the allocator runs out: a pool a solve ran an 80 GB card
out of memory after nine solves at F=16,384. Like the caching allocator's own cache, the
pool's blocks stay reserved and are not counted as allocated
(`max_memory_allocated` does not see them), so the device's footprint is
the default pool's and this one's, about twice the eager loop's; they go
when the thread ends and no graph captured into them is left.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Callable, Optional

import torch

from moshpp_torch import kernels

# the counter of iterations run by replay: ("gn.graph", K)
GRAPH_COUNTER = "gn.graph"
# the counter of graphs captured: ("gn.capture", K)
CAPTURE_COUNTER = "gn.capture"


class CountedGraph:
    """A graph of one region and the `kernels.COUNTS` its capture recorded:
    the capture adds nothing to the totals, since it runs nothing, and each
    replay adds what the capture recorded, once. `graph` is anything with a
    `replay()` (a `torch.cuda.CUDAGraph`)."""

    def __init__(self, graph):
        self.graph = graph
        self.counts: Optional[kernels.Counts] = None
        self.buffers = None    # the static buffers it reads, where any

    def capture(self, region: Callable[[], None], capturing) -> None:
        """Call `region` inside the context `capturing`, which records it
        into the graph."""
        before = kernels.snapshot_counts()
        try:
            with capturing:
                region()
        finally:
            self.counts = kernels.snapshot_counts().since(before)
            kernels.add_counts(self.counts, -1)

    def replay(self) -> None:
        self.graph.replay()
        kernels.add_counts(self.counts)


_THREAD = threading.local()


class _Capturer:
    """Where one device's graphs of one host thread are captured: a side
    stream and a memory pool, held open by a graph of its own (a
    one-element fill). A pool is freed once no graph captured into it
    lives, and the device's and the pinned host's allocators both refuse to
    capture into a freed pool again; and the caching allocator gives a
    capture only blocks freed on its own stream. Held together, the two let
    one owner's captures reuse the blocks of the owners before it."""

    def __init__(self, index: int):
        with torch.cuda.device(index):
            self.stream = torch.cuda.Stream()
            self.pool = torch.cuda.graph_pool_handle()
            self._cell = torch.zeros(1, device=torch.device("cuda", index))
            self._graph = torch.cuda.CUDAGraph()
            with _capturing(self._graph, self.pool, self.stream):
                self._cell.zero_()


def capturer(device: torch.device) -> _Capturer:
    """The capture stream and pool of `device` on this host thread, made at
    first use. Graphs captured from one thread replay in turn on its
    streams, and no tensor in the pool lives past a capture, so every graph
    of the thread can share them."""
    held = _THREAD.__dict__.setdefault("capturers", {})
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in held:
        held[index] = _Capturer(index)
    return held[index]


def _clear_blas_workspaces() -> None:
    """Drop cuBLAS's per-stream workspaces. Around a capture this keeps the
    capture stream's workspace out of the memory that stays allocated: made
    during the capture, it lands in the graphs' pool, and dropped after it,
    it is a free block there that only the graphs' own work reuses (none of
    the pool's tensors lives past a capture). The main stream's workspace
    is made again at its next product."""
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()


@contextlib.contextmanager
def _capturing(graph, pool, stream):
    """Record what the block launches into `graph` on the side stream
    `stream`, its allocations from `pool`."""
    main = torch.cuda.current_stream(stream.device)
    stream.wait_stream(main)
    _clear_blas_workspaces()
    try:
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                yield
            finally:
                graph.capture_end()
    finally:
        _clear_blas_workspaces()
    main.wait_stream(stream)


def _signature(state, aux: dict, mask: torch.Tensor):
    """The shapes past the batch, the dtypes and the device of a stage's
    inputs."""
    tail = lambda t: (tuple(t.shape[1:]), t.dtype)
    return (mask.device, tuple(tail(t) for t in state),
            tuple((k, *tail(v)) for k, v in sorted(aux.items())), tail(mask))


class _Buffers:
    """The static inputs and outputs of the graphs of one signature: the
    state, `aux` and mask at `capacity` frames (a graph at K frames uses
    their first K rows), e_3 and the active count."""

    def __init__(self, state, aux: dict, mask: torch.Tensor, capacity: int):
        def new(t):
            return torch.empty((capacity,) + tuple(t.shape[1:]),
                               dtype=t.dtype, device=t.device)
        self.capacity = capacity
        self.state = type(state)(*[new(t) for t in state])
        self.aux = {k: new(v) for k, v in aux.items()}
        self.mask = new(mask)
        self.e_3 = torch.empty((), dtype=mask.dtype, device=mask.device)
        self.count = torch.zeros((), dtype=torch.int64, device=mask.device)

    def views(self, K: int):
        """(state, aux, mask) of the first K frames."""
        return (type(self.state)(*[t[:K] for t in self.state]),
                {k: v[:K] for k, v in self.aux.items()}, self.mask[:K])


class IterationGraphs:
    """The graphs of one owner's dogleg iterations, by key, at most
    `max_keys` of them (module docstring)."""

    # the keys held at most, the least recently used dropped first
    max_keys = 64

    def __init__(self):
        # key -> CountedGraph, or None once met and run eagerly; the least
        # recently used first
        self._graphs = collections.OrderedDict()
        self._buffers = {}     # signature -> [_Buffers], capacity ascending

    def __len__(self) -> int:
        """The keys met."""
        return len(self._graphs)

    def clear(self) -> None:
        """Drop the graphs and the buffers."""
        self._graphs.clear()
        self._buffers.clear()

    def _get(self, key):
        """The graph of `key` (None where met and not captured), marked as
        used last; `_UNMET` where the key is not held."""
        graph = self._graphs.get(key, _UNMET)
        if graph is not _UNMET:
            self._graphs.move_to_end(key)
        return graph

    def _put(self, key, graph) -> None:
        """Hold `graph` under `key`, dropping the least recently used key
        past `max_keys` and then the buffers that no graph left reads. A
        set is only ever added above the largest of its signature, so the
        set a held graph reads stays the least that fits its batch."""
        self._graphs[key] = graph
        self._graphs.move_to_end(key)
        if len(self._graphs) <= self.max_keys:
            return
        self._graphs.popitem(last=False)
        read = {id(g.buffers) for g in self._graphs.values() if g is not None}
        for sig in list(self._buffers):
            kept = [b for b in self._buffers[sig] if id(b) in read]
            if kept:
                self._buffers[sig] = kept
            else:
                del self._buffers[sig]

    def stage(self, ident, iterate: Callable, active: Callable, state,
              aux: dict, mask: torch.Tensor, e_3: float) -> "Stage":
        """A run of iterations from `state` (a NamedTuple of tensors with a
        leading batch) on fixed `aux` and `mask`.

        `ident` is hashable and names the iteration's arithmetic (the
        system and options); `iterate(state, aux, mask, e_3)` returns the
        next state, `active(state)` the count of frames still active (a
        device scalar). e_3 reaches `iterate` as a float when it runs
        eagerly and as a device scalar when it is captured."""
        sig = _signature(state, aux, mask)
        K = int(mask.shape[0])
        return Stage(self, (ident, K, sig), sig, K, iterate, active, aux,
                     mask, e_3)

    def _buffers_for(self, sig, K: int, state, aux, mask) -> _Buffers:
        """The buffers of `sig` with the least capacity of at least K;
        new ones at K where none is that large."""
        sets = self._buffers.setdefault(sig, [])
        for b in sets:
            if b.capacity >= K:
                return b
        b = _Buffers(state, aux, mask, K)
        sets.append(b)
        return b

    def engages(self, state, aux: dict) -> bool:
        """Whether a stage of `state` and `aux` can be captured: all of
        them CUDA tensors."""
        return all(torch.is_tensor(t) and t.is_cuda
                   for t in (*state, *aux.values()))

    def _capture(self, key, region: Callable[[], None], buffers: _Buffers,
                 device) -> CountedGraph:
        """Capture `region`, which reads and writes `buffers`, under
        `key`."""
        graph = CountedGraph(self._new_graph())
        graph.capture(region, self._recording(graph.graph, device))
        graph.buffers = buffers
        self._put(key, graph)
        return graph

    def _new_graph(self):
        return torch.cuda.CUDAGraph()

    def _recording(self, graph, device):
        """The context that records into `graph`: on the thread's capture
        stream, from its pool."""
        c = capturer(device)
        return _capturing(graph, c.pool, c.stream)


_UNMET = object()


class Stage:
    """One run of iterations at one key (`IterationGraphs.stage`)."""

    def __init__(self, graphs: IterationGraphs, key, sig, K, iterate, active,
                 aux, mask, e_3):
        self.graphs, self.key, self.sig, self.K = graphs, key, sig, K
        self.iterate, self.active = iterate, active
        self.aux, self.mask, self.e_3 = aux, mask, e_3
        self.buffers: Optional[_Buffers] = None

    def step(self, state):
        """One iteration: (the next state, the device scalar that holds the
        next active count, or None where the caller counts them)."""
        graphs = self.graphs
        graph = graphs._get(self.key)
        if graph is _UNMET:
            graphs._put(self.key, None)
            return self.iterate(state, self.aux, self.mask, self.e_3), None
        if self.buffers is None:
            self._load(state)
            kernels.count_frames(CAPTURE_COUNTER, self.K, int(graph is None))
        if graph is None:
            graph = graphs._capture(self.key, self._region(), self.buffers,
                                    self.mask.device)
        graph.replay()
        kernels.count_frames(GRAPH_COUNTER, self.K)
        views = self.buffers.views(self.K)[0]
        return views, self.buffers.count

    def _region(self) -> Callable[[], None]:
        """One iteration on the buffers, its state and count written back
        into them."""
        b = self.buffers
        state, aux, mask = b.views(self.K)

        def region():
            out = self.iterate(state, aux, mask, b.e_3)
            for buf, new in zip(state, out):
                buf.copy_(new)
            b.count.copy_(self.active(out))
        return region

    def _load(self, state) -> None:
        """Copy the stage's inputs into its buffers."""
        b = self.graphs._buffers_for(self.sig, self.K, state, self.aux,
                                     self.mask)
        views, aux, mask = b.views(self.K)
        for buf, t in zip(views, state):
            buf.copy_(t)
        for k, v in self.aux.items():
            aux[k].copy_(v)
        mask.copy_(self.mask)
        b.e_3.fill_(self.e_3)
        self.buffers = b

    def finish(self, state):
        """The stage's final state, copied out of the buffers where it lies
        in them (a later stage overwrites them)."""
        if self.buffers is None:
            return state
        return type(state)(*[t.clone() for t in state])
