"""Batched dogleg trust-region Gauss-Newton solver.

Port of `moshpp_tpu/solver/gauss_newton.py`, batched over a leading problem
dimension. A problem comes either as a `GNSystem` that assembles (f, g, B)
directly (stage ii) or as a residual function, whose Jacobian comes from
forward-mode AD (`dogleg_solve`, `batched_dogleg_solve`: stage i). The JAX
loop is a device `while_loop`; here it is a Python loop that reads the
number of active problems on the host once per iteration — one device sync
per iteration, counted in `SolveResult.host_syncs`.

Straggler compaction (`batched_system_solve`): the full batch iterates while
more than N/b problems are active (for each b of `compact_buckets`), then a
stable argsort of the done flags gathers the stragglers into an N/b bucket,
which finishes alone; the results are scattered back.
`batched_system_solve_traced` runs the plain loop for exactly `maxiter`
iterations with no host read and records each iteration.

Handed an `IterationGraphs` (`solver/graphs.py`, the stage-ii schedule's
private `_graphs`, kept with the problem), a CUDA solve whose direction
is the PCG kernel replays each iteration as a CUDA graph, one a batch
shape: the same kernels on the same inputs, one launch and one read an
iteration.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from moshpp_torch import kernels
from moshpp_torch.solver.graphs import IterationGraphs
from moshpp_torch.utils import spans
from moshpp_torch.utils.spans import span, spanned

# The values the JAX package's `jac_precision` takes: it hands the field to
# `jax.default_matmul_precision` (moshpp_tpu/solver/gauss_newton.py:374,
# moshpp_tpu/pipeline/stageii.py:697), whose values these are.
JAC_PRECISIONS = (
    "default", "high", "highest", "bfloat16", "tensorfloat32", "float32",
    "ANY_F8_ANY_F8_F32", "ANY_F8_ANY_F8_F32_FAST_ACCUM", "ANY_F8_ANY_F8_ANY",
    "ANY_F8_ANY_F8_ANY_FAST_ACCUM", "F16_F16_F16", "F16_F16_F32",
    "BF16_BF16_BF16", "BF16_BF16_F32", "BF16_BF16_F32_X3", "BF16_BF16_F32_X6",
    "BF16_BF16_F32_X9", "TF32_TF32_F32", "TF32_TF32_F32_X3", "F32_F32_F32",
    "F64_F64_F64")


def check_choice(field: str, value, choices) -> None:
    """Raise a ValueError that names `field` unless `value` is one of
    `choices`."""
    if value not in choices:
        raise ValueError(f"{field}={value!r}: expected one of {choices}")


@dataclasses.dataclass(frozen=True)
class DoglegOptions:
    maxiter: int = 100
    e_3: float = 1e-3          # relative improvement stop (chumpy's e_3)
    delta_0: float = 0.5       # initial trust radius
    delta_max: float = 100.0
    min_delta: float = 1e-10
    accept_ratio: float = 1e-4  # minimum rho to accept a step
    damping: float = 1e-8      # Tikhonov floor on the normal equations
    f_atol: float = 1e-20      # absolute cost floor
    g_rtol: float = 1e-7       # gradient stop: |g| <= g_rtol * (1 + f)
    linear_solver: str = "cholesky"  # 'cholesky' | 'pcg'
    cg_iters: int = 24
    # the JAX package's matmul precision of the Jacobian and normal-equation
    # assembly (one of JAC_PRECISIONS). A no-op here: J comes from forward
    # AD or the kernels in float32 and B from one float32 matmul with TF32
    # off, at least JAX's 'highest' whatever the value.
    jac_precision: str = "highest"

    def __post_init__(self):
        check_choice("jac_precision", self.jac_precision, JAC_PRECISIONS)


class GNSystem(NamedTuple):
    """Batched problem spec.

    system_fn(x (N, D), aux) -> (f (N,), g (N, D), B (N, D, D)): cost |r|^2,
      gradient Jᵀr and GN Hessian JᵀJ, all terms included; B symmetric.
    cost_fn(x (N, D), aux) -> f (N,), for trial points.
    """
    system_fn: Callable
    cost_fn: Callable


class SolveResult(NamedTuple):
    x: torch.Tensor          # final parameters
    cost: torch.Tensor       # final |r|^2
    iterations: torch.Tensor
    converged: torch.Tensor  # stopped on e_3 (vs maxiter/stalled radius)
    host_syncs: int          # device-to-host reads of the loop condition


class _State(NamedTuple):
    x: torch.Tensor
    f: torch.Tensor
    delta: torch.Tensor
    it: torch.Tensor
    done: torch.Tensor
    converged: torch.Tensor
    plin: torch.Tensor   # (N, D) previous GN direction (PCG warm start)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _bmv(B, v):
    return torch.bmm(B, v[..., None])[..., 0]


@spanned(spans.CHOLESKY)
def _gn_direction_cholesky(g, B):
    """Exact GN direction via Cholesky: (p_gn (N, D), ok (N,))."""
    L, info = torch.linalg.cholesky_ex(B)
    ok = (info == 0) & torch.isfinite(L).flatten(1).all(dim=1)
    eye = torch.eye(B.shape[-1], dtype=B.dtype, device=B.device)
    L = torch.where(ok[:, None, None], L, eye)
    p_gn = -torch.cholesky_solve(g[..., None], L)[..., 0]
    return torch.where(ok[:, None], p_gn, torch.zeros_like(g)), ok


def _gn_direction_pcg(g, B, plin, iters: int):
    """Approximate GN direction via Jacobi-preconditioned CG on B p = -g,
    warm-started from `plin` when that beats x0 = 0; breakdown freezes the
    iterate. Returns (p_gn, ok)."""
    rhs = -g
    dinv = 1.0 / torch.clamp(torch.diagonal(B, dim1=-2, dim2=-1), min=1e-12)
    r_warm = rhs - _bmv(B, plin)
    use_warm = ((_dot(r_warm, r_warm) < _dot(rhs, rhs))
                & torch.isfinite(plin).all(dim=-1))[:, None]
    x = torch.where(use_warm, plin, torch.zeros_like(g))
    r = torch.where(use_warm, r_warm, rhs)
    z = dinv * r
    p = z
    rz = _dot(r, z)
    rz0 = torch.clamp(rz, min=1e-30)
    active = rz > 0
    one = torch.ones_like(rz)
    for _ in range(iters):
        Bp = _bmv(B, p)
        pBp = _dot(p, Bp)
        step_ok = active & (pBp > 1e-30) & (rz > 1e-12 * rz0)
        alpha = torch.where(step_ok, rz / torch.where(pBp > 0, pBp, one), 0.0)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * Bp
        z = dinv * r
        rz_new = _dot(r, z)
        beta = torch.where(step_ok, rz_new / torch.where(rz > 0, rz, one), 0.0)
        p = torch.where(step_ok[:, None], z + beta[:, None] * p, p)
        rz = torch.where(step_ok, rz_new, rz)
        active = step_ok
    ok = (_dot(g, x) < 0) & torch.isfinite(x).all(dim=-1)
    return torch.where(ok[:, None], x, torch.zeros_like(g)), ok


def _damp(B, opts: DoglegOptions):
    """Tikhonov floor scaled by the mean diagonal."""
    D = B.shape[-1]
    tr = torch.diagonal(B, dim1=-2, dim2=-1).sum(-1)
    lam = opts.damping * (tr / D + 1.0)
    eye = torch.eye(D, dtype=B.dtype, device=B.device)
    return B + lam[:, None, None] * eye


def _dogleg_geometry(g, B, delta, p_gn, ok):
    """Dogleg step within |p| <= delta given a (possibly failed) GN
    direction; g/B already masked and damped."""
    inf = torch.full_like(delta, float("inf"))
    gn_norm = torch.where(ok, torch.linalg.vector_norm(p_gn, dim=-1), inf)
    gBg = _dot(g, _bmv(B, g)) + 1e-30
    gg = _dot(g, g)
    p_sd = -(gg / gBg)[:, None] * g
    sd_norm = torch.linalg.vector_norm(p_sd, dim=-1)
    d = p_gn - p_sd
    a = _dot(d, d) + 1e-30
    b = 2.0 * _dot(p_sd, d)
    c = _dot(p_sd, p_sd) - delta * delta
    disc = torch.clamp(b * b - 4.0 * a * c, min=0.0)
    t = (-b + torch.sqrt(disc)) / (2.0 * a)
    seg = p_sd + torch.clamp(t, 0.0, 1.0)[:, None] * d
    col = lambda m: m[:, None]
    return torch.where(
        col((gn_norm <= delta) & ok), p_gn,
        torch.where(col(sd_norm >= delta),
                    p_sd * (delta / (sd_norm + 1e-30))[:, None],
                    torch.where(col(ok), seg, p_sd)))


def _masked_system(g, B, mask):
    """Freeze masked params exactly: zero gradient, identity rows/cols."""
    g = g * mask
    B = B * (mask[:, :, None] * mask[:, None, :]) + torch.diag_embed(1.0 - mask)
    return g, B


def _post_step_from_pred(s: _State, g_norm, pred, p, p_gn, x_new, f_new,
                         opts: DoglegOptions, e_3) -> _State:
    """Accept test, trust-region update and stopping flags, batched."""
    actual = s.f - f_new
    rho = actual / torch.clamp(pred, min=1e-30)
    p_norm = torch.linalg.vector_norm(p, dim=-1)
    accept = (rho > opts.accept_ratio) & torch.isfinite(f_new)
    delta = torch.where(
        rho < 0.25,
        0.25 * p_norm,
        torch.where((rho > 0.75) & (p_norm >= 0.99 * s.delta),
                    torch.clamp(2.0 * s.delta, max=opts.delta_max),
                    s.delta))
    delta = torch.clamp(delta, min=opts.min_delta)

    x = torch.where(accept[:, None], x_new, s.x)
    f = torch.where(accept, f_new, s.f)

    small_improvement = accept & (actual < e_3 * torch.clamp(s.f, min=1e-30))
    tiny_cost = f <= opts.f_atol
    tiny_grad = g_norm <= opts.g_rtol * (1.0 + s.f)
    stalled = (~accept) & (delta <= opts.min_delta * 1.001)
    done = small_improvement | stalled | tiny_cost | tiny_grad

    frozen = s.done
    keep = lambda old, new: torch.where(
        frozen.reshape(frozen.shape + (1,) * (new.dim() - 1)), old, new)
    return _State(
        x=keep(s.x, x), f=keep(s.f, f), delta=keep(s.delta, delta),
        it=torch.where(frozen, s.it, s.it + 1),
        done=s.done | done,
        converged=s.converged | (~frozen & (small_improvement | tiny_cost
                                            | tiny_grad)),
        plin=keep(s.plin, p_gn))


def _direction(g, B, s: _State, mask, opts: DoglegOptions):
    """(p, p_gn, pred) for the masked gradient `g` and RAW `B`."""
    if opts.linear_solver == "pcg":
        from moshpp_torch.solver.pcg import dogleg_direction_batched
        return dogleg_direction_batched(g, B, s.plin, mask, s.delta,
                                        opts.cg_iters, opts.damping)
    gm, Bm = _masked_system(g, B, mask)
    Bd = _damp(Bm, opts)
    p_gn, ok = _gn_direction_cholesky(gm, Bd)
    p = _dogleg_geometry(gm, Bd, s.delta, p_gn, ok) * mask
    pred = -(2.0 * _dot(gm, p) + _dot(p, _bmv(Bd, p)))
    return p, p_gn, pred


def _step(system: GNSystem, opts: DoglegOptions, e_3, s: _State, aux,
          mask) -> _State:
    """One dogleg iteration for the whole batch."""
    _, g, B = system.system_fn(s.x, aux)
    with span(spans.DIRECTION):
        g = g * mask
        p, p_gn, pred = _direction(g, B, s, mask, opts)
        x_new = s.x + p
    f_new = system.cost_fn(x_new, aux)
    with span(spans.POST_STEP):
        g_norm = torch.linalg.vector_norm(g, dim=-1)
        return _post_step_from_pred(s, g_norm, pred, p, p_gn, x_new, f_new,
                                    opts, e_3)


def _iterate(system: GNSystem, opts: DoglegOptions, e_3, s: _State, aux,
             mask) -> _State:
    """One dogleg iteration and the iteration limit's done flags."""
    s = _step(system, opts, e_3, s, aux, mask)
    return s._replace(done=s.done | (s.it >= opts.maxiter))


def _active_count(s: _State, maxiter: int) -> torch.Tensor:
    """The frames still iterating, a device scalar."""
    return ((~s.done) & (s.it < maxiter)).sum()


def _init_state(x0, f0, opts: DoglegOptions) -> _State:
    N = x0.shape[0]
    dev = x0.device
    return _State(
        x=x0, f=f0,
        delta=torch.full((N,), opts.delta_0, dtype=x0.dtype, device=dev),
        it=torch.zeros(N, dtype=torch.int32, device=dev),
        done=torch.zeros(N, dtype=torch.bool, device=dev),
        converged=torch.zeros(N, dtype=torch.bool, device=dev),
        plin=torch.zeros_like(x0))


def _take(tree, idx):
    if isinstance(tree, dict):
        return {k: v[idx] for k, v in tree.items()}
    return type(tree)(*[v[idx] for v in tree])


def _full_mask(x0: torch.Tensor, param_mask: Optional[torch.Tensor]):
    """The (N, D) {0, 1} mask of x0's parameters: all ones, or param_mask
    (D,) or (N, D) broadcast."""
    if param_mask is None:
        return torch.ones_like(x0)
    return param_mask.to(x0.dtype).expand(x0.shape).contiguous()


@spanned(spans.GN_SOLVE)
def batched_system_solve(system: GNSystem,
                         x0: torch.Tensor,
                         aux: dict,
                         options: DoglegOptions = DoglegOptions(),
                         param_mask: Optional[torch.Tensor] = None,
                         e_3: Optional[float] = None,
                         compact_buckets: Tuple[int, ...] = (4, 16),
                         *, _graphs: Optional[IterationGraphs] = None
                         ) -> SolveResult:
    """Batched dogleg with straggler compaction.

    x0 (N, D); every `aux` value carries a leading N; param_mask (D,) or
    (N, D) {0, 1}, zero entries frozen at x0. `compact_buckets=()` runs the
    plain batched loop.

    Each iteration adds to `kernels.COUNTS.frames` one at ("gn.step", K)
    and its active frames at ("gn.active", K), K the iteration's batch (N
    or a compaction bucket): their sums are the frame-iterations (the
    final `iterations` summed) and the rows computed. Both counts are on
    the host already: no sync, no launch.

    `_graphs` (private: the stage-ii schedule's) replays the iterations as
    CUDA graphs where x0 and `aux` are on CUDA and the direction is the
    PCG kernel; those iterations also count one at ("gn.graph", K), and
    each run of them adds one at ("gn.capture", K) where it captured its
    graph, zero where it found the graph made. The
    Cholesky route runs eagerly: cuSOLVER's batched factorisation is not
    known to be capturable.
    """
    opts = options
    e_3 = opts.e_3 if e_3 is None else e_3
    N = x0.shape[0]
    mask = _full_mask(x0, param_mask)
    syncs = 0
    graphs = _graphs if (_graphs is not None and opts.linear_solver == "pcg"
                         and _graphs.engages((x0,), aux)) else None

    def iterate(s, aux_s, mask_s, e3):
        return _iterate(system, opts, e3, s, aux_s, mask_s)

    def active(s):
        return _active_count(s, opts.maxiter)

    def run_stage(s: _State, aux_s, mask_s, min_active: int) -> _State:
        nonlocal syncs
        batch = s.x.shape[0]
        stage = None if graphs is None else graphs.stage(
            (system, opts), iterate, active, s, aux_s, mask_s, e_3)
        count = None    # the next active count, where a replay wrote it
        while True:
            with span(spans.ACTIVE_READ):
                n_active = int(active(s) if count is None else count)
            syncs += 1
            if n_active == 0 or (min_active > 0 and n_active <= min_active):
                return s if stage is None else stage.finish(s)
            kernels.count_frames("gn.step", batch)
            kernels.count_frames("gn.active", batch, n_active)
            with span(spans.STEP):
                if stage is None:
                    s = iterate(s, aux_s, mask_s, e_3)
                else:
                    s, count = stage.step(s)

    s = _init_state(x0, system.cost_fn(x0, aux), opts)
    buckets = [N // b for b in compact_buckets if N // b >= 8]
    if not buckets:
        s = run_stage(s, aux, mask, 0)
    else:
        s = run_stage(s, aux, mask, buckets[0])
        levels = [(s, aux, mask)]
        idxs = []
        for i, K in enumerate(buckets):
            s_o, aux_o, mask_o = levels[-1]
            with span(spans.COMPACT):
                # stable: actives first, in their original order
                idx = torch.argsort(s_o.done.to(torch.int32), stable=True)[:K]
                aux_i, mask_i = _take(aux_o, idx), mask_o[idx]
                s_i = _take(s_o, idx)
            nxt = buckets[i + 1] if i + 1 < len(buckets) else 0
            sub = run_stage(s_i, aux_i, mask_i, nxt)
            levels.append((sub, aux_i, mask_i))
            idxs.append(idx)
        with span(spans.SCATTER):
            inner = levels[-1][0]
            for lvl in range(len(idxs) - 1, -1, -1):
                outer = levels[lvl][0]
                merged = []
                for a, b in zip(outer, inner):
                    a = a.clone()
                    a[idxs[lvl]] = b
                    merged.append(a)
                inner = _State(*merged)
        s = inner
    return SolveResult(x=s.x, cost=s.f, iterations=s.it,
                       converged=s.converged, host_syncs=syncs)


def batched_system_solve_traced(system: GNSystem,
                                x0: torch.Tensor,
                                aux: dict,
                                options: DoglegOptions = DoglegOptions(),
                                param_mask: Optional[torch.Tensor] = None,
                                e_3: Optional[float] = None,
                                record_x: bool = False):
    """`batched_system_solve` with a per-iteration record of the optimizer
    (`moshpp_tpu/solver/gauss_newton.py::batched_system_solve_traced`): the
    headless stand-in for the reference's on-step visualisation
    (chmosh.py:235-245, 516-519); `tools/profile_stageii_torch.py --trace`
    writes it as CSV.

    Runs exactly `options.maxiter` iterations on the whole batch, with no
    early exit, no compaction and no device-to-host read inside the loop
    (`host_syncs` 0): frames that are done stay frozen as in the
    production loop, so x, the cost and the per-frame iterations equal the
    plain loop's (`compact_buckets=()`). Returns (SolveResult, trace), the
    trace tensors on x0's device, (maxiter, N): `f`, `delta`, `accepted`
    (the frame was active and its x moved) and `active` (not done before
    the iteration), and with `record_x` also `x` (maxiter, N, D). A
    debugging tool: it always costs maxiter full iterations.
    """
    opts = options
    e_3 = opts.e_3 if e_3 is None else e_3
    N, D = x0.shape
    T = opts.maxiter
    mask = _full_mask(x0, param_mask)
    empty = lambda *shape, dtype=x0.dtype: torch.empty(
        (T,) + shape, dtype=dtype, device=x0.device)
    trace = {"f": empty(N), "delta": empty(N),
             "accepted": empty(N, dtype=torch.bool),
             "active": empty(N, dtype=torch.bool)}
    if record_x:
        trace["x"] = empty(N, D)
    with fp32_matmul():
        s = _init_state(x0, system.cost_fn(x0, aux), opts)
        for i in range(T):
            x_prev, done_prev = s.x, s.done
            s = _iterate(system, opts, e_3, s, aux, mask)
            # an accepted step moves x (pred ~ 0 forces rho ~ 0, a reject),
            # so a moved x is the accept decision, as in the JAX package
            trace["f"][i] = s.f
            trace["delta"][i] = s.delta
            trace["accepted"][i] = (~done_prev) & torch.any(s.x != x_prev,
                                                            dim=-1)
            trace["active"][i] = ~done_prev
            if record_x:
                trace["x"][i] = s.x
    return SolveResult(x=s.x, cost=s.f, iterations=s.it,
                       converged=s.converged, host_syncs=0), trace


@contextlib.contextmanager
def fp32_matmul():
    """Full-float32 products for a solve: TF32 off for cuBLAS and cuDNN,
    restored afterwards (the JAX package's "highest" matmul precision)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _residual_system(residual_fn: Callable, batched_aux: bool) -> GNSystem:
    """A batched `GNSystem` from a residual r = residual_fn(x (D,), aux) of
    one problem: r and J = dr/dx by `torch.func.jacfwd`, vmapped over the
    batch (and over `aux`'s leading dim when `batched_aux`), then f = rᵀr,
    g = Jᵀr and B = JᵀJ as float32 `bmm`s."""
    def r_twice(x, aux):
        r = residual_fn(x, aux)
        return r, r

    in_dims = (0, 0 if batched_aux else None)
    jac = torch.func.vmap(torch.func.jacfwd(r_twice, has_aux=True),
                          in_dims=in_dims)
    res = torch.func.vmap(residual_fn, in_dims=in_dims)

    def system_fn(x, aux):
        with span(spans.JACFWD):
            J, r = jac(x, aux)
        with span(spans.NORMAL_EQUATIONS):
            Jt = J.transpose(1, 2)
            return (torch.sum(r * r, dim=-1),
                    torch.bmm(Jt, r[..., None])[..., 0], torch.bmm(Jt, J))

    def cost_fn(x, aux):
        r = res(x, aux)
        return torch.sum(r * r, dim=-1)

    return GNSystem(system_fn, cost_fn)


def batched_dogleg_solve(residual_fn: Callable, x0: torch.Tensor, aux,
                         options: DoglegOptions = DoglegOptions(),
                         param_mask: Optional[torch.Tensor] = None,
                         e_3: Optional[float] = None) -> SolveResult:
    """Minimize |residual_fn(x_n, aux_n)|^2 for every problem n of a batch.

    residual_fn(x (D,), aux_slice) -> r (R,), traceable by `torch.func`;
    `aux` is a dict of tensors with a leading N (or None); x0 (N, D);
    param_mask (D,) or (N, D), zero entries frozen at x0; `e_3` overrides
    `options.e_3`. Every problem iterates until all have stopped, each
    frozen once it stops (no compaction, as in the JAX package)."""
    system = _residual_system(residual_fn, batched_aux=aux is not None)
    with fp32_matmul():
        return batched_system_solve(system, x0, aux, options,
                                    param_mask=param_mask, e_3=e_3,
                                    compact_buckets=())


def dogleg_solve(residual_fn: Callable[[torch.Tensor], torch.Tensor],
                 x0: torch.Tensor,
                 options: DoglegOptions = DoglegOptions(),
                 param_mask: Optional[torch.Tensor] = None,
                 e_3: Optional[float] = None) -> SolveResult:
    """Minimize |residual_fn(x)|^2 from x0 (D,): `batched_dogleg_solve` on
    a batch of one. The result's x is (D,), its cost, iterations and
    converged flag scalars."""
    res = batched_dogleg_solve(lambda x, _: residual_fn(x), x0[None], None,
                               options, param_mask=param_mask, e_3=e_3)
    return res._replace(x=res.x[0], cost=res.cost[0],
                        iterations=res.iterations[0],
                        converged=res.converged[0])
