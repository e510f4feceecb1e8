"""The host-side rule and the arithmetic of the redesigned `fk_smalls`
kernel, on the CPU.

(a) `fk_frames_per_block`, the frames a block of an fk_smalls launch:
    `FK_MAX_FRAMES` with inline extras, one with the Jacobian, else
    ceil(F / sms) up to `FK_MAX_FRAMES` (the solve's F = 128 and 512 take 1
    and 4 on the H100's 132 SMs), every frame covered;
(b) the ancestor masks the kernel walks: each joint's bits, in ascending
    order, are its root path, on every family;
(c) the kernel's per-thread arithmetic written in PyTorch (each joint
    composes its own root path G = L_root ... L_j, Q and b being the
    transform before the last product; with inline extras the path sums
    S_e[j] = S_e[parent] + Q_j dtrel_e[j] and datr = S - G_rot djnt)
    against the plain versions on the four families and the three routes,
    and through the plain marker rows to sim and jm against the JAX
    package's Pallas kernels in interpret mode (E = 0, and 8 DMPLs).

Inputs are made from numpy seeds.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from moshpp_tpu.ops.pallas_marker_jac import (
    marker_sim_and_jacobian as jax_marker_sim_and_jacobian)

from moshpp_torch.ops import marker_jac as mj
from moshpp_torch.ops.lbs_jacobian import JointSmalls
from moshpp_torch.ops.rodrigues import rodrigues_with_grad

from test_torch_extras import _marker_problem as extras_problem
from test_torch_extras_tables import FAMILIES, _tables
from test_torch_marker_jac import _problem as family_problem

torch.set_num_threads(1)


@pytest.mark.parametrize("F,sms,nf", [
    (1, 132, 1), (128, 132, 1), (132, 132, 1), (133, 132, 2), (264, 132, 2),
    (265, 132, 3), (512, 132, 4), (528, 132, 4), (529, 132, 4),
    (2048, 132, 4), (4096, 132, 4), (17, 16, 2), (100, 16, 4), (5, 1, 4)])
def test_frames_per_block(F, sms, nf):
    """Without the Jacobian and inline extras ceil(F / sms) frames a block,
    between 1 and FK_MAX_FRAMES: the blocks cover every frame, and while
    F <= sms * FK_MAX_FRAMES a block of more than one frame leaves no SM
    with two. With the Jacobian one frame a block, with inline extras
    FK_MAX_FRAMES, at every F."""
    for route in ("", "tiled"):
        got = mj.fk_frames_per_block(F, sms, False, route)
        assert got == nf and 1 <= got <= mj.FK_MAX_FRAMES == 4
        blocks = -(-F // got)
        assert blocks * got >= F > (blocks - 1) * got
        if F <= sms * mj.FK_MAX_FRAMES:
            assert blocks <= sms or got == 1
        assert mj.fk_frames_per_block(F, sms, True, route) == 1
    for with_jac in (True, False):
        assert mj.fk_frames_per_block(F, sms, with_jac, "ext") == 4


def _path(tables, j):
    """Joint j's root path from its ancestor mask: the set bits, ascending."""
    bits = int(tables.ancmask[j]) & (2 ** 64 - 1)
    return [k for k in range(tables.num_joints) if bits >> k & 1]


@pytest.mark.parametrize("family,dph", FAMILIES)
def test_ancestor_bits_are_root_paths(family, dph):
    """Each joint's mask bits, ascending, are its chain from the root down
    to itself, as walking `parents` up gives it."""
    _, _, tables = _tables(family, dph, 7)
    for j in range(tables.num_joints):
        chain, k = [], j
        while k >= 0:
            chain.append(k)
            k = tables.parents[k]
        assert _path(tables, j) == chain[::-1]


def _kernel_twin(theta, tables, with_jac, extra=None, jshift=None):
    """fk_smalls as csrc/fk_smalls.cu computes it, in float32: the local
    transforms (R, the frame's rest offset), then per joint the product
    along its root path, the Jacobian terms from Q and b, the transform
    before the path's last product, and with inline extras the path sums."""
    F, J = theta.shape[:2]
    E = tables.n_extra if extra is not None else 0
    R, dR = rodrigues_with_grad(theta)
    tr = tables.trel.expand(F, J, 3).clone()
    jn = tables.jnts.expand(F, J, 3).clone()
    if E:
        tr = tr + torch.einsum("fe,jec->fjc", extra, tables.dtrel)
        jn = jn + torch.einsum("fe,jec->fjc", extra, tables.djnt)
    if jshift is not None:
        tr = tr + jshift[:, 0]
        jn = jn + jshift[:, 1]
    eye = torch.eye(3).expand(F, 3, 3)
    G_rot, G_tr = torch.empty((F, J, 3, 3)), torch.empty((F, J, 3))
    Q, b = torch.empty((F, J, 3, 3)), torch.zeros((F, J, 3))
    datr = torch.empty((F, E, J, 3)) if E else None
    for j in range(J):
        path = _path(tables, j)
        g_rot, g_tr, q = R[:, path[0]], tr[:, path[0]], eye
        S = tables.dtrel[path[0]].expand(F, E, 3) if E else None
        for k in path[1:]:
            q, b[:, j] = g_rot, g_tr
            if E:
                S = torch.einsum("fab,eb->fea", q, tables.dtrel[k]) + S
            g_rot = q @ R[:, k]
            g_tr = torch.einsum("fab,fb->fa", q, tr[:, k]) + b[:, j]
        G_rot[:, j], G_tr[:, j], Q[:, j] = g_rot, g_tr, q
        if E:
            datr[:, :, j] = S - torch.einsum("fab,eb->fea", g_rot,
                                             tables.djnt[j])
    atr = G_tr - torch.einsum("fjab,fjb->fja", G_rot, jn)
    feat = (R[:, 1:] - torch.eye(3)).contiguous()
    if not with_jac:
        return JointSmalls(G_rot, atr, feat)
    dRRt = torch.einsum("fjabt,fjcb->fjact", dR, R)
    u = -torch.einsum("fjabt,fjb->fjat", dRRt, tr)
    W = torch.einsum("fjab,fjbct,fjdc->fjadt", Q, dRRt, Q)
    W_tr = (-torch.einsum("fjabt,fjb->fjat", W, b)
            + torch.einsum("fjab,fjbt->fjat", Q, u))
    return JointSmalls(G_rot, atr, feat, W, W_tr, dR, datr,
                       Q if jshift is not None else None)


def _check_smalls(k, p):
    for f, a, b in zip(k._fields, k, p):
        assert (a is None) == (b is None), f
        if a is not None:
            torch.testing.assert_close(a, b, rtol=0, atol=2e-6, msg=f)


@pytest.mark.parametrize("E", [0, 8, 20])
@pytest.mark.parametrize("family,dph", FAMILIES)
def test_kernel_arithmetic_matches_plain(family, dph, E):
    """The path products and sums give the plain versions' joint
    quantities within 2e-6 (float32 rounding of other summation orders),
    with and without the Jacobian: E=0, 8 inline DMPLs (datr), 20 on the
    tiled route (q)."""
    model, _, tables = _tables(family, dph, 7, seed=E, E=E)
    rng = np.random.default_rng(E + 1)
    x = torch.as_tensor((rng.normal(size=(5, tables.dof)) * 0.5)
                        .astype(np.float32))
    x[0] = 0.0
    theta, _, extra = mj.kernel_inputs(model, tables, x)
    for with_jac in (True, False):
        if tables.route == "tiled":
            jshift, _ = mj.extra_shifts(tables, extra)
            twin = _kernel_twin(theta, tables, with_jac, jshift=jshift)
            plain = mj.fk_smalls_tiled_plain(theta, jshift, tables, with_jac)
        else:
            twin = _kernel_twin(theta, tables, with_jac, extra)
            plain = mj.fk_smalls_plain(theta, tables, with_jac, extra)
        _check_smalls(twin, plain)


@pytest.mark.parametrize("E", [0, 8])
def test_kernel_arithmetic_matches_pallas(E):
    """The kernel's arithmetic, through the plain marker rows, gives the JAX
    package's sim and jm (its Pallas `_smalls_kernel[_ext]` and
    `_marker_kernel[_ext]` in interpret mode) within the tolerances of
    tests/test_pallas_jac.py: 3e-5 m, 3e-4 max(|jm|, 1)."""
    if E:
        p = extras_problem("dmpl", E)
        jm_, jt, tm, tt, x = p["jm"], p["jt"], p["tm"], p["tt"], p["x"]
    else:
        jm_, jt, tm, tt, rng = family_problem("smplh", 7)
        x = (rng.normal(size=(3, 3 + tm.pose_dof)) * 0.4).astype(np.float32)
    sim_r, jac_r = jax_marker_sim_and_jacobian(jm_, jt, jnp.asarray(x),
                                               interpret=True)
    theta, trans, extra = mj.kernel_inputs(tm, tt, torch.tensor(x))
    sm = _kernel_twin(theta, tt, True, extra)
    assert (sm.datr is not None) == bool(E)
    sim, jac = mj.marker_rows_plain(sm, trans, tt, True, extra)
    np.testing.assert_allclose(sim.numpy(), np.asarray(sim_r), rtol=0,
                               atol=3e-5)
    scale = max(float(np.abs(np.asarray(jac_r)).max()), 1.0)
    np.testing.assert_allclose(jac.numpy(), np.asarray(jac_r), rtol=0,
                               atol=3e-4 * scale)
