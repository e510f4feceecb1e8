"""Fused batched dogleg direction on the H100.

Port of `moshpp_tpu/solver/pallas_pcg.py::dogleg_direction_batched`: the
Pallas `_direction_kernel` becomes the hand-written CUDA kernel
`csrc/dogleg_direction.cu`. The wrapper takes B batch-major, (N, D, D)
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


def direction_test_system(n: int, d: int, cond: float, *, seed: int = 0,
                          device="cpu"):
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
    if not g.is_cuda:
        return dogleg_direction_plain(g, B, plin, mask, delta, iters, damping)
    N, D = g.shape
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
