"""Fused batched dogleg direction, and the plain PCG direction, on the H100.

Port of `moshpp_tpu/solver/pallas_pcg.py`: the Pallas `_direction_kernel`
(`dogleg_direction_batched`) and `_pcg_kernel` (`pcg_direction_batched`)
become the two modes of the hand-written CUDA kernel
`csrc/dogleg_direction.cu`. The wrappers take B batch-major, (N, D, D)
contiguous per frame; the TPU's frame-minor (D, D, N) layout lever is not
ported. A CPU tensor runs the plain PyTorch version, a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import torch

from moshpp_torch import kernels
from moshpp_torch.solver.gauss_newton import (DoglegOptions, _bmv, _damp,
                                              _dogleg_geometry, _dot,
                                              _gn_direction_pcg,
                                              _masked_system)

KERNEL = "dogleg_direction"
PCG_KERNEL = "pcg_direction"
# Both modes hold in dynamic shared memory two vectors of D floats rounded
# up to 4 and the frame's B: whole (D^2 floats and 3 of room to align its
# copy) where that fits a block, else as rows d = 0..D-1, row d from column
# d & ~3 on, zero-padded to a length of 4 modulo 32 floats; beside them 768
# B of static block-sum scratch (2 rows of 3 x 32 floats). An H100 block may
# have 232,448 B: whole B to D=239 (D=206, the SMPL-X face path: 172,188 B),
# the rows to D=320.
SMEM_PER_BLOCK = 232_448
SMEM_STATIC = 2 * 3 * 32 * 4
MAX_DIRECTION_WIDTH = 320


def _row_len(d: int, D: int) -> int:
    """Stored floats of row d: the least length >= D - (d & ~3) that is 4
    modulo 32."""
    return ((D - (d & ~3) - 4 + 31) & ~31) + 4


def direction_smem_bytes(D: int) -> int:
    """Shared memory of one direction-kernel block at width D."""
    vectors = 2 * ((D + 3) & ~3)
    whole = (vectors + D * D + 3) * 4 + SMEM_STATIC
    if whole <= SMEM_PER_BLOCK:
        return whole
    return (vectors + sum(_row_len(d, D) for d in range(D))) * 4 + SMEM_STATIC


def check_direction_width(D: int) -> None:
    """Raise for a D whose B does not fit one block's shared memory; on
    every device, so that a CPU run refuses what the card would."""
    need = direction_smem_bytes(D)
    if need > SMEM_PER_BLOCK:
        raise ValueError(
            f"the direction kernel at D={D} needs {need} B of shared memory a "
            f"block; the kernel has {SMEM_PER_BLOCK} B "
            f"(D <= {MAX_DIRECTION_WIDTH})")


def dogleg_direction_plain(g, B, plin, mask, delta, iters: int,
                           damping: float):
    """Plain PyTorch version: the chain _masked_system -> _damp ->
    _gn_direction_pcg -> _dogleg_geometry -> pred, with the warm start
    masked as the kernel masks it."""
    kernels.note_plain(KERNEL, g)
    opts = DoglegOptions(damping=damping)
    gm, Bm = _masked_system(g, B, mask)
    Bd = _damp(Bm, opts)
    p_gn, ok = _gn_direction_pcg(gm, Bd, plin * mask, iters)
    p = _dogleg_geometry(gm, Bd, delta, p_gn, ok) * mask
    pred = -(2.0 * _dot(gm, p) + _dot(p, _bmv(Bd, p)))
    return p, p_gn, pred


def pcg_direction_plain(g, B, plin, iters: int):
    """Plain PyTorch version of the PCG mode: `_gn_direction_pcg`."""
    kernels.note_plain(PCG_KERNEL, g)
    return _gn_direction_pcg(g, B, plin, iters)


def _in_orders(fn, args, seeds):
    """fn(*args) with the unknowns in the given order and in one fixed
    random order per seed, each output put back in the given order: (N, D)
    arguments and outputs are permuted along D, (N, D, D) ones along both,
    the rest pass as they are."""
    D = args[0].shape[1]
    outs = [fn(*args)]
    for seed in seeds:
        perm = torch.randperm(D, generator=torch.Generator().manual_seed(
            seed)).to(args[0].device)
        inv = torch.argsort(perm)

        def permuted(t):
            if not torch.is_tensor(t) or t.dim() < 2:
                return t
            t = t[:, perm]
            return (t[:, :, perm] if t.dim() == 3 else t).contiguous()
        out = fn(*map(permuted, args))
        outs.append(tuple(o[:, inv] if o.dim() == 2 else o for o in out))
    return outs


def plain_in_orders(g, B, plin, mask, delta, iters: int, damping: float,
                    seeds=(1, 2)):
    """The plain version's outputs (p, p_gn, pred) with the unknowns in the
    given order and in one fixed random order per seed, each put back in the
    given order: unconverged CG is chaotic in the summation order, and these
    runs measure how far float32 alone moves the result."""
    return _in_orders(dogleg_direction_plain,
                      (g, B, plin, mask, delta, iters, damping), seeds)


def pcg_plain_in_orders(g, B, plin, iters: int, seeds=(1, 2)):
    """`plain_in_orders` of the PCG mode: (p_gn, ok) in each order."""
    return _in_orders(pcg_direction_plain, (g, B, plin, iters), seeds)


def direction_test_system(n: int, d: int, cond: float, *, seed: int = 0,
                          device):
    """Inputs (g, B, plin, mask, delta), float32 on `device`, on which a
    wrong direction kernel shows: CG has not converged after 24 iterations,
    so the iterates carry the recurrence, the preconditioner and the warm
    start, yet the system is tame enough that float32 stays near float64.

    B = S Q diag(lam) Q^T S with lam log-spaced over [1, cond] (Jacobi-scaled
    condition number ~cond) and S log-uniform over [0.1, 10], so dropping the
    Jacobi preconditioner raises it ~1e4-fold. g = -B_masked x* for a target
    x* with |x*| in [0.03, 3], radii in [0.01, 3]: the GN, Cauchy and segment
    branches all occur. plin is near x* on even frames (the warm start is
    taken) and random on odd ones (rejected); ~10% of unknowns are masked.
    Drawn in float64 on the CPU from `seed`, so every device gets the same.
    """
    gen = torch.Generator().manual_seed(seed)
    f64 = dict(dtype=torch.float64, generator=gen)
    Q, _ = torch.linalg.qr(torch.randn((n, d, d), **f64))
    lam = torch.logspace(0.0, float(torch.log10(torch.tensor(cond))), d,
                         dtype=torch.float64)
    s = torch.exp(torch.empty((n, d), dtype=torch.float64).uniform_(
        -2.3, 2.3, generator=gen))
    B = s[:, :, None] * (Q * lam) @ Q.transpose(1, 2) * s[:, None, :]
    B = 0.5 * (B + B.transpose(1, 2))
    mask = (torch.rand((n, d), **f64) > 0.1).double()
    size = torch.exp(torch.empty(n, dtype=torch.float64).uniform_(
        -3.5, 1.1, generator=gen))
    x = torch.randn((n, d), **f64) * mask
    x = x * (size / torch.linalg.vector_norm(x, dim=-1))[:, None]
    _, Bm = _masked_system(x, B, mask)
    g = -_bmv(Bm, x) * mask
    plin = 0.1 * torch.randn((n, d), **f64)
    near = x + 0.05 * size[:, None] * torch.randn((n, d), **f64) / d ** 0.5
    plin[0::2] = near[0::2]
    delta = torch.exp(torch.empty(n, dtype=torch.float64).uniform_(
        -4.6, 1.1, generator=gen))
    return tuple(t.to(device=device, dtype=torch.float32).contiguous()
                 for t in (g, B, plin, mask, delta))


def dogleg_direction_batched(g: torch.Tensor, B: torch.Tensor,
                             plin: torch.Tensor, mask: torch.Tensor,
                             delta: torch.Tensor, iters: int, damping: float):
    """Fused batched dogleg direction from RAW normal equations.

    (g_masked (N, D), B (N, D, D) raw symmetric, plin (N, D), mask (N, D),
    delta (N,)) -> (p (N, D) dogleg step, p_gn (N, D) warm start for the
    next iteration, pred (N,) model reduction).
    """
    N, D = g.shape
    check_direction_width(D)
    if not g.is_cuda:
        return dogleg_direction_plain(g, B, plin, mask, delta, iters, damping)
    for name, t, shape in (("g", g, (N, D)), ("B", B, (N, D, D)),
                           ("plin", plin, (N, D)), ("mask", mask, (N, D)),
                           ("delta", delta, (N,))):
        kernels.check(name, t, shape)
    p = torch.empty_like(g)
    p_gn = torch.empty_like(g)
    pred = torch.empty_like(delta)
    P = kernels.ptr
    kernels.launch("dogleg_direction_launch", KERNEL, N, D, int(iters),
                   float(damping), P(g), P(B), P(plin), P(mask), P(delta),
                   P(p), P(p_gn), P(pred))
    return p, p_gn, pred


def pcg_direction_batched(g: torch.Tensor, B: torch.Tensor,
                          plin: torch.Tensor, iters: int):
    """Batched Gauss-Newton direction by Jacobi-PCG on B p = -g.

    (g (N, D), B (N, D, D) symmetric, already masked and damped by the
    caller, plin (N, D) warm start) -> (p_gn (N, D), zero where not ok;
    ok (N,) bool: g.p_gn < 0 and p_gn finite). The warm start is taken only
    where it lowers the residual, and a breakdown freezes the iterate. No
    solve calls it, in the port as in the JAX package, whose dogleg takes the
    fused `dogleg_direction_batched`; it is the entry point of the Pallas
    `_pcg_kernel`.
    """
    N, D = g.shape
    check_direction_width(D)
    if not g.is_cuda:
        return pcg_direction_plain(g, B, plin, iters)
    for name, t, shape in (("g", g, (N, D)), ("B", B, (N, D, D)),
                           ("plin", plin, (N, D))):
        kernels.check(name, t, shape)
    p_gn = torch.empty_like(g)
    ok = torch.empty((N,), dtype=torch.bool, device=g.device)
    P = kernels.ptr
    kernels.launch("pcg_direction_launch", PCG_KERNEL, N, D, int(iters),
                   P(g), P(B), P(plin), P(p_gn), P(ok))
    return p_gn, ok
