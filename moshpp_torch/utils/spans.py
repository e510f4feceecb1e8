"""Profiler spans of the port: one gated helper and the table of every
span name.

`span(name)` is `torch.profiler.record_function(name)` while a profiler
records, and one shared null context otherwise: a bare `record_function`
costs ~9 us to enter and leave with no profiler running, the gated helper
under 1 us, and a stage-ii solve opens ~10 spans in each of its ~200-300
dogleg iterations. The spans land on the profiler's host timeline, on the
clock of the device activity, so an idle gap of the device is put down to
the innermost span open at its middle.

The stage-ii tree (one host thread; nesting is the parent link; one
`stageii.solve` is one request):

    stageii.solve            mosh_stageii_solve, the whole call
      stageii.chunk          each chunk of a long sequence (its own
                             stageii.solve inside)
      stageii.rigid_init
      stageii.phase.<name>   each phase: anneal10, anneal5, anneal1,
                             anchor_step2, step1, step2, sweep, polish
        stageii.velo_aux
        stageii.report       the report's energies before and after the
                             phase (return_report only; once more at the
                             end, where they are read)
        gn.solve             batched_system_solve (stage i's solves too)
          gn.active_read     the read of the active count: the host sync
          gn.step            one dogleg iteration and its done update; an
                             iteration replayed as a CUDA graph (the
                             counter ("gn.graph", K)) opens none of the
                             spans below: they open only on an iteration
                             run eagerly or captured
            stageii.system   the system's assembly
              stageii.data_rows   marker rows, Jacobian and weighting
              stageii.normal_eq   f, g and B from the data rows
              stageii.prior       prior and regularisers
            gn.direction     the direction (kernel or gn.cholesky)
            stageii.cost     the cost at the trial point
            gn.post_step     accept test, radius, stopping flags
          gn.compact         a compaction bucket's argsort and gathers
          gn.scatter         the buckets merged back
      stageii.slerp          the anchor pass's interpolation
      stageii.finalize

`SPANS` maps every name to its layer, as PERF.md's list of layers names
them; the benchmark's idle metrics split the device's idle time inside
`stageii.solve` by these layers.
"""

from __future__ import annotations

import contextlib
import functools

import torch

SCHEDULE = "stage-ii schedule (pipeline/stageii.py)"
SYSTEM = "stage-ii system assembly (make_stageii_system)"
DOGLEG = "batched dogleg (solver/gauss_newton.py)"
STAGEI = "stage i (pipeline/stagei.py)"

SOLVE = "stageii.solve"
CHUNK = "stageii.chunk"
RIGID_INIT = "stageii.rigid_init"
PHASE_PREFIX = "stageii.phase."
VELO_AUX = "stageii.velo_aux"
REPORT = "stageii.report"
SLERP = "stageii.slerp"
FINALIZE = "stageii.finalize"
ASSEMBLY = "stageii.system"
DATA_ROWS = "stageii.data_rows"
NORMAL_EQ = "stageii.normal_eq"
PRIOR = "stageii.prior"
CALLABLE_PRIOR = "stageii.callable_prior"
COST = "stageii.cost"
GN_SOLVE = "gn.solve"
ACTIVE_READ = "gn.active_read"
STEP = "gn.step"
DIRECTION = "gn.direction"
POST_STEP = "gn.post_step"
COMPACT = "gn.compact"
SCATTER = "gn.scatter"
CHOLESKY = "gn.cholesky"
JACFWD = "gn.jacfwd"
NORMAL_EQUATIONS = "gn.normal_equations"
FREEZE = "stagei.freeze"

# the stage-ii schedule's phases in the order they run (the smoothing
# sweeps each open their own `sweep`; the report's slot is "sweeps")
PHASES = ("anneal10", "anneal5", "anneal1", "anchor_step2", "step1", "step2",
          "sweep", "polish")


def phase(name: str) -> str:
    """The span of stage-ii phase `name`."""
    return PHASE_PREFIX + name


SPANS = {
    SOLVE: SCHEDULE, CHUNK: SCHEDULE, RIGID_INIT: SCHEDULE,
    **{phase(p): SCHEDULE for p in PHASES},
    VELO_AUX: SCHEDULE, REPORT: SCHEDULE, SLERP: SCHEDULE,
    FINALIZE: SCHEDULE,
    ASSEMBLY: SYSTEM, DATA_ROWS: SYSTEM, NORMAL_EQ: SYSTEM, PRIOR: SYSTEM,
    CALLABLE_PRIOR: SYSTEM, COST: SYSTEM,
    # the residual-driven system (stage i): its Jacobian and normal equations
    JACFWD: SYSTEM, NORMAL_EQUATIONS: SYSTEM,
    GN_SOLVE: DOGLEG, ACTIVE_READ: DOGLEG, STEP: DOGLEG, DIRECTION: DOGLEG,
    POST_STEP: DOGLEG, COMPACT: DOGLEG, SCATTER: DOGLEG, CHOLESKY: DOGLEG,
    FREEZE: STAGEI,
}

_NULL = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """A profiler range named `name` while a profiler records on this
    thread, else a shared null context."""
    if _recording():
        return torch.profiler.record_function(name)
    return _NULL


def spanned(name: str):
    """Decorator: each call of the function inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap
