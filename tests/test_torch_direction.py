"""The port's fused dogleg direction (`moshpp_torch.solver.pcg`) against the
JAX package's Pallas `_direction_kernel`, run in interpret mode on the CPU.

On CPU tensors the wrapper runs the plain PyTorch chain, the version the
CUDA kernel is held to on the card. Tolerances are those of
tests/test_solver.py::test_fused_direction_matches_xla_chain.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from moshpp_tpu.solver.gauss_newton import (
    _gn_direction_cholesky as jax_cholesky)
from moshpp_tpu.solver.pallas_pcg import (
    dogleg_direction_batched as jax_direction)

from moshpp_torch.solver.gauss_newton import (_gn_direction_cholesky,
                                              _dogleg_geometry, _damp,
                                              _masked_system, DoglegOptions)
from moshpp_torch.solver import pcg
from moshpp_torch.solver.pcg import dogleg_direction_batched

torch.set_num_threads(1)


def _norms(g, B, plin, mask, iters):
    """|p_gn| and |p_sd| per frame from the plain chain."""
    t = [torch.tensor(a) for a in (g, B, plin, mask)]
    big = torch.full((g.shape[0],), 1e6)
    _, p_gn, _ = dogleg_direction_batched(*t, big, iters=iters, damping=1e-8)
    gm, Bm = _masked_system(t[0], t[1], t[3])
    Bd = _damp(Bm, DoglegOptions(damping=1e-8))
    gBg = torch.einsum("nd,nde,ne->n", gm, Bd, gm)
    sd_norm = (gm * gm).sum(-1) / gBg * torch.linalg.vector_norm(gm, dim=-1)
    return torch.linalg.vector_norm(p_gn, dim=-1).numpy(), sd_norm.numpy()


def _inputs(seed, N=6, D=17, iters=20):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(N, D, D)).astype(np.float32)
    B = (A @ A.transpose(0, 2, 1) + 3.0 * np.eye(D)).astype(np.float32)
    g = rng.normal(size=(N, D)).astype(np.float32)
    plin = (rng.normal(size=(N, D)) * 0.1).astype(np.float32)
    mask = (rng.uniform(size=(N, D)) > 0.3).astype(np.float32)
    g = g * mask
    # radii for the three dogleg branches in turn: inside the Cauchy point
    # (scaled SD step), between it and the GN point (segment), beyond the
    # GN point (full GN step)
    gn, sd = _norms(g, B, plin, mask, iters)
    lo, hi = np.minimum(gn, sd), np.maximum(gn, sd)
    delta = np.stack([0.5 * lo, 0.5 * (lo + hi), 2.0 * hi])[
        np.arange(N) % 3, np.arange(N)].astype(np.float32)
    return g, B, plin, mask, delta


def _regions(g, B, plin, mask, delta, iters):
    """Which dogleg branch each frame takes: 0 GN, 1 scaled SD, 2 segment."""
    gn, sd = _norms(g, B, plin, mask, iters)
    return np.where(gn <= delta, 0, np.where(sd >= delta, 1, 2))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_direction_matches_pallas(seed):
    g, B, plin, mask, delta = _inputs(seed)
    p_r, pgn_r, pred_r = jax_direction(
        jnp.asarray(g), jnp.asarray(B), jnp.asarray(plin), jnp.asarray(mask),
        jnp.asarray(delta), iters=20, damping=1e-8, interpret=True)
    p, p_gn, pred = dogleg_direction_batched(
        *[torch.tensor(a) for a in (g, B, plin, mask, delta)],
        iters=20, damping=1e-8)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_r), rtol=2e-4,
                               atol=1e-5)
    np.testing.assert_allclose(p_gn.numpy(), np.asarray(pgn_r), rtol=2e-4,
                               atol=1e-5)
    np.testing.assert_allclose(pred.numpy(), np.asarray(pred_r), rtol=2e-3,
                               atol=1e-6)
    assert set(_regions(g, B, plin, mask, delta, 20)) == {0, 1, 2}


def test_cholesky_direction_matches_jax():
    g, B, _, mask, _ = _inputs(4)
    gm, Bm = _masked_system(torch.tensor(g), torch.tensor(B),
                            torch.tensor(mask))
    Bd = _damp(Bm, DoglegOptions())
    p, ok = _gn_direction_cholesky(gm, Bd)
    for n in range(g.shape[0]):
        p_r, ok_r = jax_cholesky(jnp.asarray(gm[n].numpy()),
                                 jnp.asarray(Bd[n].numpy()))
        assert bool(ok[n]) == bool(ok_r)
        np.testing.assert_allclose(p[n].numpy(), np.asarray(p_r), rtol=2e-4,
                                   atol=1e-5)


def _variant(g, B, plin, mask, delta, iters, precond=True, warm="auto",
             guards=True):
    """The plain chain with one fault a direction kernel could have: no
    Jacobi preconditioner, a warm start never or always taken, or no
    breakdown guards (CG runs on past convergence)."""
    opts = DoglegOptions(damping=1e-8)
    gm, Bm = _masked_system(g, B, mask)
    Bd = _damp(Bm, opts)
    bmv = lambda v: torch.bmm(Bd, v[..., None])[..., 0]
    dot = lambda a, b: (a * b).sum(-1)
    diag = torch.diagonal(Bd, dim1=-2, dim2=-1)
    dinv = 1.0 / diag if precond else torch.ones_like(diag)
    pl = plin * mask
    r_warm = -gm - bmv(pl)
    use = {"auto": dot(r_warm, r_warm) < dot(gm, gm),
           "never": torch.zeros_like(delta, dtype=torch.bool),
           "always": torch.ones_like(delta, dtype=torch.bool)}[warm][:, None]
    x = torch.where(use, pl, torch.zeros_like(pl))
    r = torch.where(use, r_warm, -gm)
    z = dinv * r
    p, rz = z, dot(r, z)
    rz0, active = rz.clamp(min=1e-30), rz > 0
    for _ in range(iters):
        Bp = bmv(p)
        pBp = dot(p, Bp)
        step = active & (pBp > 1e-30) & (rz > 1e-12 * rz0) if guards else active
        alpha = torch.where(step, rz / pBp, 0.0)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * Bp
        z = dinv * r
        rz_new = dot(r, z)
        p = torch.where(step[:, None], z + (rz_new / rz)[:, None] * p, p)
        rz = torch.where(step, rz_new, rz)
        active = step
    ok = dot(gm, x) < 0
    p_gn = torch.where(ok[:, None], x, torch.zeros_like(x))
    p = _dogleg_geometry(gm, Bd, delta, p_gn, ok) * mask
    return p, p_gn, -(2.0 * dot(gm, p) + dot(p, bmv(p)))


@pytest.mark.parametrize("cond,iters,fault", [
    (1e2, 24, "half the iterations"), (1e2, 24, "two iterations short"),
    (1e2, 24, "no preconditioner"), (1e2, 24, "warm start never"),
    (1e2, 24, "warm start always"), (1e3, 128, "half the iterations"),
    (1e3, 128, "no preconditioner"), (5.0, 128, "no breakdown guards")])
def test_direction_test_system_catches_faults(cond, iters, fault):
    """On pcg.direction_test_system a direction with one fault lands well
    outside the bar the card holds the kernel to (4x the float32 plain
    version's distance from float64 in some output), while 24 and 128
    iterations give different steps."""
    args = pcg.direction_test_system(256, 117, cond, seed=3)
    a64 = [t.double() for t in args]
    ref = dogleg_direction_batched(*a64, iters=iters, damping=1e-8)
    plain = dogleg_direction_batched(*args, iters=iters, damping=1e-8)
    e_plain = [float((a.double() - r).abs().max()) for a, r in zip(plain, ref)]
    it, kw = {"half the iterations": (iters // 2, {}),
              "two iterations short": (iters - 2, {}),
              "no preconditioner": (iters, dict(precond=False)),
              "warm start never": (iters, dict(warm="never")),
              "warm start always": (iters, dict(warm="always")),
              "no breakdown guards": (iters, dict(guards=False))}[fault]
    faithful = _variant(*args, iters)
    for a, b in zip(faithful, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    bad = _variant(*args, it, **kw)
    ratio = max(float((a.double() - r).abs().max()) / e
                for a, r, e in zip(bad, ref, e_plain))
    assert ratio > 8.0, ratio
    if cond >= 1e2:
        other = dogleg_direction_batched(*a64, damping=1e-8,
                                         iters=24 if iters == 128 else 128)
        assert float((other[0] - ref[0]).abs().max()) > 10.0 * e_plain[0]


def test_geometry_regions_are_exercised():
    """The radii in `_inputs` reach all three dogleg branches."""
    g, B, plin, mask, delta = _inputs(0, N=12)
    assert set(_regions(g, B, plin, mask, delta, 20)) == {0, 1, 2}
    p_gn = torch.zeros((12, 17))
    step = _dogleg_geometry(torch.tensor(g), torch.tensor(B),
                            torch.tensor(delta), p_gn,
                            torch.zeros(12, dtype=torch.bool))
    # a failed GN direction falls back to the (scaled) Cauchy step
    assert torch.all(torch.linalg.vector_norm(step, dim=-1)
                     <= torch.tensor(delta) * (1 + 1e-5) + 1e-6)
