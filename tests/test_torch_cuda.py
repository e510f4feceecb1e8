"""The port's Hopper kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU with the CUDA toolkit (the kernels build with nvcc at
first use); skips elsewhere. The machine with the card has no JAX, so this
file imports none and runs without the suite's conftest:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py -q

Small shapes with ragged frame counts; chip_smoke.py repeats the comparison
at the main path's shapes.
"""

import ctypes
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from moshpp_torch import kernels  # noqa: E402
from moshpp_torch.models import make_synthetic_model  # noqa: E402
from moshpp_torch.ops import marker_jac as mj  # noqa: E402
from moshpp_torch.ops.marker_transform import (marker_coeffs,  # noqa: E402
                                               select_frame_indices)
from moshpp_torch.solver import gauss_newton, pcg  # noqa: E402

pytestmark = pytest.mark.cuda

TOL_SIM = 2e-5


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _object_model(device):
    """A rigid prop as a one-joint model: zero-width posedirs, no hands."""
    from moshpp_torch.models.object_model import (RigidObjectModel,
                                                  object_as_surface_model)
    from moshpp_torch.models.synthetic import icosphere
    sv, sf = icosphere(3)
    return object_as_surface_model(RigidObjectModel(
        torch.as_tensor((sv * [0.11, 0.07, 0.19]).astype(np.float32),
                        device=device),
        torch.as_tensor(sf.astype(np.int64), device=device)))


def _tables(family, dof_per_hand, M, device, seed=0, E=0):
    """Tables of a 300-vertex model with 10 betas (the object: its one
    shape column) and, with E, E extra (DMPL) columns right after them."""
    rng = np.random.default_rng(seed)
    if family == "object":
        model = _object_model(device)
    else:
        model = make_synthetic_model(family, num_verts=300, seed=4,
                                     dof_per_hand=dof_per_hand, device=device,
                                     num_shape_dirs=10 + E if E else None)
    nb = min(10, model.num_shape_dirs)
    betas = torch.as_tensor((rng.normal(size=nb) * 0.3).astype(np.float32),
                            device=device)
    can_v = model.v_template + torch.einsum("vcb,b->vc",
                                            model.shapedirs[..., :nb], betas)
    vids = rng.choice(can_v.shape[0], M, replace=False)
    lat = can_v[vids] + 0.01
    idx = select_frame_indices(can_v, lat)
    coeffs = marker_coeffs(can_v, lat, idx)
    return model, mj.prepare_marker_jac_tables(
        model, idx, coeffs, betas, extra_cols=range(10, 10 + E)), rng


def _frame_inputs(model, device, rng, M):
    """(frame indices, coefficients, betas) of M markers on a model, drawn
    as `_tables` draws them."""
    nb = min(10, model.num_shape_dirs)
    betas = torch.as_tensor((rng.normal(size=nb) * 0.3).astype(np.float32),
                            device=device)
    can_v = model.v_template + torch.einsum("vcb,b->vc",
                                            model.shapedirs[..., :nb], betas)
    lat = can_v[rng.choice(can_v.shape[0], M, replace=False)] + 0.01
    idx = select_frame_indices(can_v, lat)
    return idx, marker_coeffs(can_v, lat, idx), betas


CASES = [("smplh", 6, 7), ("smplh", 24, 46), ("smpl", 0, 5), ("mano", 6, 7),
         ("smplx", 24, 46), ("animal_horse", 0, 46), ("animal_dog", 0, 46),
         ("object", 0, 10)]


@pytest.mark.parametrize("family,dph,M", CASES)
@pytest.mark.parametrize("with_jac", [True, False])
def test_fk_smalls_kernel_matches_plain(dev, family, dph, M, with_jac):
    model, tables, rng = _tables(family, dph or 6, M, dev)
    x = torch.as_tensor((rng.normal(size=(37, 3 + model.pose_dof)) * 0.5)
                        .astype(np.float32), device=dev)
    x[0] = 0.0
    theta, _, _ = mj.kernel_inputs(model, tables, x)
    k = mj.fk_smalls(theta, tables, with_jac)
    p = mj.fk_smalls_plain(theta, tables, with_jac)
    torch.cuda.synchronize()
    for f, a, b in zip(k._fields, k, p):
        if b is None:
            assert a is None
            continue
        torch.testing.assert_close(a, b, rtol=0, atol=2e-5, msg=f)


# fk_smalls' frame counts off its blocks: 1, 129, and for the rule's choices
# on a 132-SM card (ceil(F / sms) frames a block without the Jacobian and
# inline extras) counts that take 2, 3 and 4 and end in a ragged block
# (sms + 1, 2 sms + 2, 3 sms + 5), and one past the cap of 4 (4 sms + 7);
# each also ragged at the other choices (129 at 2, 133 at 3, 535 at 4)
def _fk_frame_counts(sms):
    return (1, 129, sms + 1, 2 * sms + 2, 3 * sms + 5, 4 * sms + 7)


def _check_fk(k, p, datr_tol=1e-6):
    """An fk_smalls kernel's outputs against its plain version's: every
    field within 2e-5, datr within datr_tol of its largest entry (at least
    1), and every field written (finite)."""
    for f, a, b in zip(k._fields, k, p):
        if b is None:
            assert a is None, f
            continue
        assert torch.isfinite(a).all(), f
        atol = (datr_tol * max(float(b.abs().max()), 1.0) if f == "datr"
                else 2e-5)
        torch.testing.assert_close(a, b, rtol=0, atol=atol, msg=f)


def _fk_both(tables, theta, extra, jshift, with_jac):
    """(kernel, plain) outputs of the route's fk_smalls."""
    if tables.route == "tiled":
        return (mj.fk_smalls_tiled(theta, jshift, tables, with_jac),
                mj.fk_smalls_tiled_plain(theta, jshift, tables, with_jac))
    return (mj.fk_smalls(theta, tables, with_jac, extra),
            mj.fk_smalls_plain(theta, tables, with_jac, extra))


@pytest.mark.parametrize("E", [0, 8, 20])
@pytest.mark.parametrize("with_jac", [True, False])
@pytest.mark.parametrize("family,dph", [("mano", 6), ("smpl", 6),
                                        ("smplh", 24), ("smplx", 24)])
def test_fk_smalls_frame_counts(dev, monkeypatch, family, dph, with_jac, E):
    """Every fk_smalls instantiation (E=0, inline E=8, tiled E=20) on the
    four families' trees (J = 16, 24, 52, 55: a frame's records at J=55 end
    off 16 bytes) at frame counts that end in a ragged block, at its own
    frames a block and at each of 1-4 forced, against its plain version;
    every launch gives the same bits as the first F frames of the widest
    launch at 1 frame a block."""
    model, tables, rng = _tables(family, dph, 7, dev, E=E)
    sms = kernels.sm_count(torch.device(dev))
    counts = _fk_frame_counts(sms)
    x = torch.as_tensor((rng.normal(size=(max(counts), tables.dof)) * 0.5)
                        .astype(np.float32), device=dev)
    x[0] = 0.0
    theta, _, extra = mj.kernel_inputs(model, tables, x)
    jshift = (mj.extra_shifts(tables, extra)[0] if tables.route == "tiled"
              else None)
    cut = lambda a, F: None if a is None else a[:F]
    rule = mj.fk_frames_per_block
    if not with_jac and tables.route != "ext":
        assert {rule(F, sms, with_jac, tables.route)
                for F in counts} == {1, 2, 3, 4}
    widest = None
    for nf in (1, 2, 3, 4, None):
        monkeypatch.setattr(mj, "fk_frames_per_block",
                            rule if nf is None else lambda *a, nf=nf: nf)
        for F in reversed(counts):
            k, p = _fk_both(tables, theta[:F], cut(extra, F), cut(jshift, F),
                            with_jac)
            torch.cuda.synchronize()
            _check_fk(k, p)
            if widest is None:
                widest = k
                continue
            for f, a, b in zip(k._fields, k, widest):
                if a is not None:
                    assert torch.equal(a, b[:F]), (nf, F, f)


def _tree_tables(J, E, seed, dev):
    """fk_smalls tables of a random J-joint tree (parents first, chains up
    to ~J/3 deep) with E extra dims: the smplh tables with their tree, rest
    joints and extra directions replaced."""
    from moshpp_torch.models.body_model import _ancestor_matrix
    rng = np.random.default_rng(seed)
    parents = tuple([-1] + [j - 1 if rng.random() < 0.6
                            else int(rng.integers(0, j)) for j in range(1, J)])
    _, base, _ = _tables("smplh", 24, 7, dev, E=min(E, 16))
    jnts = rng.normal(size=(J, 3)).astype(np.float32) * 0.2
    djnt = rng.normal(size=(J, E, 3)).astype(np.float32) * 0.05
    trel, dtrel = jnts.copy(), djnt.copy()
    for j, p in enumerate(parents):
        if p >= 0:
            trel[j] -= jnts[p]
            dtrel[j] -= djnt[p]
    anc = _ancestor_matrix(parents)
    bits = (anc.astype(np.uint64) << np.arange(J, dtype=np.uint64)).sum(
        axis=1, dtype=np.uint64)
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=dev)
    return dataclasses.replace(
        base, parents=parents, parents_t=t(np.asarray(parents), torch.int32),
        jnts=t(jnts), trel=t(trel), anc=t(anc),
        ancmask=t(bits.view(np.int64), torch.int64), djnt=t(djnt),
        dtrel=t(dtrel)), rng


@pytest.mark.parametrize("route", ["", "ext", "tiled"])
@pytest.mark.parametrize("with_jac", [True, False])
@pytest.mark.parametrize("J", [64, 33, 1])
def test_fk_smalls_widest_trees(dev, monkeypatch, J, with_jac, route):
    """fk_smalls at the limits it takes, J = 64 joints and E = 16 inline
    extra dims, and on a 33-joint and a one-joint tree, at every
    frames-a-block choice, against its plain version (datr within 1e-6)."""
    rule = mj.fk_frames_per_block
    E = {"": 0, "ext": 16, "tiled": 0}[route]
    tables, rng = _tree_tables(J, E, J + E, dev)
    assert tables.num_joints == J and tables.n_extra == E
    sms = kernels.sm_count(torch.device(dev))
    # the rule's own frames a block at F = 1 and 129, then 2, 3, 1, 4
    for F, nf in zip(_fk_frame_counts(sms), (None, None, 2, 3, 1, 4)):
        monkeypatch.setattr(mj, "fk_frames_per_block",
                            rule if nf is None else lambda *a, nf=nf: nf)
        theta = torch.as_tensor((rng.normal(size=(F, J, 3)) * 0.6)
                                .astype(np.float32), device=dev)
        extra = (torch.as_tensor(rng.normal(size=(F, E)).astype(np.float32),
                                 device=dev) if E else None)
        jshift = (torch.as_tensor((rng.normal(size=(F, 2, J, 3)) * 0.05)
                                  .astype(np.float32), device=dev)
                  if route == "tiled" else None)
        k, p = _fk_both(tables, theta, extra, jshift, with_jac)
        torch.cuda.synchronize()
        _check_fk(k, p)


def test_fk_smalls_occupancy(dev):
    """fk_smalls' occupancy export: every instantiation at the slices'
    widths (J=52, 52 with E=8, 55 tiled) and at the limits (J=64, E=16)
    fits a block an SM at 1-4 frames a block, with nf * J threads rounded to
    warps; it refuses 5 frames, 65 joints, 17 inline extra dims and extra
    dims on the wrong route."""
    lib, _ = kernels.library()
    smem, threads = ctypes.c_int(), ctypes.c_int()
    for jac in (1, 0):
        for route, J, E in ((0, 52, 0), (1, 52, 8), (2, 55, 0), (0, 64, 0),
                            (1, 64, 16), (2, 64, 0)):
            for nf in (1, 2, 3, 4):
                blocks = lib.fk_smalls_occupancy(jac, route, J, E, nf,
                                                 ctypes.byref(smem),
                                                 ctypes.byref(threads))
                assert blocks >= 1, (jac, route, J, E, nf)
                assert threads.value == -(-nf * J // 32) * 32
                assert 0 < smem.value <= 232448
    for args in ((1, 0, 52, 0, 5), (1, 0, 65, 0, 1), (1, 1, 52, 17, 1),
                 (1, 0, 52, 8, 1), (1, 2, 55, 8, 1), (1, 1, 52, 0, 1)):
        assert lib.fk_smalls_occupancy(*args, ctypes.byref(smem),
                                       ctypes.byref(threads)) == 0, args


@pytest.mark.parametrize("family,dph,M", CASES)
@pytest.mark.parametrize("with_jac", [True, False])
def test_marker_rows_kernel_matches_plain(dev, family, dph, M, with_jac):
    model, tables, rng = _tables(family, dph or 6, M, dev)
    x = torch.as_tensor((rng.normal(size=(37, 3 + model.pose_dof)) * 0.5)
                        .astype(np.float32), device=dev)
    theta, trans, _ = mj.kernel_inputs(model, tables, x)
    sm = mj.fk_smalls_plain(theta, tables, with_jac)
    sim_k, jm_k = mj.marker_rows(sm, trans, tables, with_jac)
    sim_p, jm_p = mj.marker_rows_plain(sm, trans, tables, with_jac)
    torch.cuda.synchronize()
    torch.testing.assert_close(sim_k, sim_p, rtol=0, atol=2e-5)
    if with_jac:
        scale = max(float(jm_p.abs().max()), 1.0)
        torch.testing.assert_close(jm_k, jm_p, rtol=0, atol=3e-4 * scale)
    else:
        assert jm_k is None


@pytest.mark.parametrize("with_jac", [True, False])
def test_fk_smalls_ext_kernel_matches_plain(dev, with_jac):
    """fk_smalls<., ext> (8 DMPL dims, full-width SMPL+H hands) at N=128,
    datr included."""
    model, tables, rng = _tables("smplh", 24, 46, dev, E=8)
    x = torch.as_tensor((rng.normal(size=(128, tables.dof)) * 0.5)
                        .astype(np.float32), device=dev)
    x[0] = 0.0
    theta, _, extra = mj.kernel_inputs(model, tables, x)
    k = mj.fk_smalls(theta, tables, with_jac, extra)
    p = mj.fk_smalls_plain(theta, tables, with_jac, extra)
    torch.cuda.synchronize()
    assert (k.datr is not None) == with_jac
    for f, a, b in zip(k._fields, k, p):
        if b is None:
            assert a is None
            continue
        torch.testing.assert_close(a, b, rtol=0, atol=2e-5, msg=f)


@pytest.mark.parametrize("with_jac", [True, False])
def test_marker_rows_ext_kernel_matches_plain(dev, with_jac):
    """marker_rows<., ext> at N=128, 46 markers, D = 3 + 114 + 8."""
    model, tables, rng = _tables("smplh", 24, 46, dev, E=8)
    x = torch.as_tensor((rng.normal(size=(128, tables.dof)) * 0.5)
                        .astype(np.float32), device=dev)
    theta, trans, extra = mj.kernel_inputs(model, tables, x)
    sm = mj.fk_smalls_plain(theta, tables, with_jac, extra)
    sim_k, jm_k = mj.marker_rows(sm, trans, tables, with_jac, extra)
    sim_p, jm_p = mj.marker_rows_plain(sm, trans, tables, with_jac, extra)
    torch.cuda.synchronize()
    torch.testing.assert_close(sim_k, sim_p, rtol=0, atol=2e-5)
    if with_jac:
        assert jm_k.shape == (128, 46, 3, 125)
        scale = max(float(jm_p.abs().max()), 1.0)
        torch.testing.assert_close(jm_k, jm_p, rtol=0, atol=3e-4 * scale)
    else:
        assert jm_k is None


@pytest.mark.parametrize("with_jac", [True, False])
@pytest.mark.parametrize("E", [20, 80])
def test_tiled_kernels_match_plain(dev, E, with_jac):
    """The tiled extras route at N=128 on full-width SMPL-X hands (46
    markers): fk_smalls<., tiled> (q included), marker_rows<., tiled> (jm's
    first 3+P columns, uv) and, with the Jacobian, extras_tangent and
    extras_cols, each fed its plain predecessor's outputs."""
    model, tables, rng = _tables("smplx", 24, 46, dev, E=E)
    assert tables.route == "tiled"
    x = torch.as_tensor((rng.normal(size=(128, tables.dof)) * 0.5)
                        .astype(np.float32), device=dev)
    x[0] = 0.0
    theta, trans, extra = mj.kernel_inputs(model, tables, x)
    jshift, vpshift = mj.extra_shifts(tables, extra)
    k = mj.fk_smalls_tiled(theta, jshift, tables, with_jac)
    p = mj.fk_smalls_tiled_plain(theta, jshift, tables, with_jac)
    torch.cuda.synchronize()
    assert (k.q is not None) == with_jac and k.datr is None
    for f, a, b in zip(k._fields, k, p):
        if b is None:
            assert a is None
            continue
        torch.testing.assert_close(a, b, rtol=0, atol=2e-5, msg=f)
    sim_k, jm_k, uv_k = mj.marker_rows_tiled(p, trans, vpshift, tables,
                                             with_jac)
    sim_p, jm_p, uv_p = mj.marker_rows_tiled_plain(p, trans, vpshift, tables,
                                                   with_jac)
    torch.cuda.synchronize()
    torch.testing.assert_close(sim_k, sim_p, rtol=0, atol=2e-5)
    if not with_jac:
        assert jm_k is None and uv_k is None
        return
    Dp = tables.dof - E
    scale = max(float(jm_p.abs().max()), 1.0)
    torch.testing.assert_close(jm_k[..., :Dp], jm_p[..., :Dp], rtol=0,
                               atol=3e-4 * scale)
    torch.testing.assert_close(uv_k, uv_p, rtol=0,
                               atol=3e-4 * max(float(uv_p.abs().max()), 1.0))
    datr_k = mj.extras_tangent(p.q, p.grot, tables)
    datr_p = mj.extras_tangent_plain(p.q, p.grot, tables)
    torch.cuda.synchronize()
    assert datr_k.shape == (128, E, 55, 3)
    torch.testing.assert_close(datr_k, datr_p, rtol=0, atol=2e-5)
    jm_k = mj.extras_cols(datr_p, uv_p, tables, jm_p.clone())
    jm_p = mj.extras_cols_plain(datr_p, uv_p, tables, jm_p.clone())
    torch.cuda.synchronize()
    assert float(jm_p[..., Dp:].abs().max()) > 1e-3
    scale = max(float(jm_p.abs().max()), 1.0)
    torch.testing.assert_close(jm_k, jm_p, rtol=0, atol=3e-4 * scale)


@pytest.mark.parametrize("D,cond", [(17, 5.0), (17, 1e2), (117, 5.0),
                                    (117, 1e2), (117, 1e3), (125, 1e2),
                                    (206, 1e2)])
@pytest.mark.parametrize("iters", [24, 128])
def test_direction_kernel_matches_plain(dev, D, cond, iters):
    """Against the plain version in float64, within 4x the float32 plain
    version's own distance from it; at cond ~5 also elementwise against the
    float32 plain version. At D=117, cond >= 1e2, 24 iterations have not
    converged, so p differs between 24 and 128 iterations; at D=17, 128
    iterations run far past convergence, through the breakdown guards. At
    D=206 (the SMPL-X face path) B and the vectors take 172,188 B of shared
    memory, past the 48 KB default: one block an SM."""
    _check_direction(dev, D, cond, iters)


@pytest.mark.parametrize("D,cond", [(32, 5.0), (32, 1e2), (33, 5.0),
                                    (33, 1e2), (206, 5.0), (239, 1e2),
                                    (240, 5.0), (241, 1e2),
                                    (pcg.MAX_DIRECTION_WIDTH, 5.0),
                                    (pcg.MAX_DIRECTION_WIDTH, 1e2),
                                    (6, 5.0), (6, 1e2), (108, 5.0),
                                    (108, 1e2), (111, 5.0), (111, 1e2)])
@pytest.mark.parametrize("iters", [24, 128])
def test_direction_kernel_ragged_widths(dev, D, cond, iters):
    """The direction kernel at widths where its warps end ragged (D=32, 33),
    at the widest D that holds the whole B (239), past it on the padded rows
    (240, 241: 1 and 2 past a multiple of 4), at the widest D, and at the
    other families' widths: the rigid object's D=6 (one system a block,
    fewer unknowns than a warp), the dog's 108 and the horse's 111; held as
    test_direction_kernel_matches_plain holds it, against the float32
    spread over three summation orders (chip_smoke.py's gate)."""
    _check_direction(dev, D, cond, iters, orders=True)


def _check_direction(dev, D, cond, iters, orders=False):
    """The direction test's gates; with `orders` the float32 plain version's
    distance from float64 is the largest over the given order and two
    permutations of the unknowns (chip_smoke.py's gate)."""
    args = pcg.direction_test_system(128, D, cond, seed=D, device=dev)
    out_k = pcg.dogleg_direction_batched(*args, iters, 1e-8)
    out_p = pcg.dogleg_direction_plain(*args, iters, 1e-8)
    out_64 = pcg.dogleg_direction_plain(*(t.double() for t in args), iters, 1e-8)
    spread = (pcg.plain_in_orders(*args, iters, 1e-8) if orders
              else [out_p])
    torch.cuda.synchronize()
    for i, (k, r) in enumerate(zip(out_k, out_64)):
        e_p = max(float((o[i].double() - r).abs().max()) for o in spread)
        torch.testing.assert_close(k.double(), r, rtol=0,
                                   atol=4.0 * e_p + 1e-6 * float(r.abs().max()))
    if cond == 5.0:
        torch.testing.assert_close(out_k[0], out_p[0], rtol=2e-4, atol=1e-5)
        torch.testing.assert_close(out_k[1], out_p[1], rtol=2e-4, atol=1e-5)
        torch.testing.assert_close(out_k[2], out_p[2], rtol=2e-3, atol=1e-6)
    if D >= 117 and cond >= 1e2:
        other = pcg.dogleg_direction_plain(*(t.double() for t in args),
                                           24 if iters == 128 else 128, 1e-8)
        e_p = float((out_p[0].double() - out_64[0]).abs().max())
        assert float((other[0] - out_64[0]).abs().max()) > 10.0 * e_p


def _fold_inputs(tables, F, rng, dev):
    """Observations near the markers and positive data weights, with a
    marker of frame 1 and all of frame 2's first two at w = 0."""
    M = tables.num_markers
    obs = torch.as_tensor(rng.normal(size=(F, M, 3)).astype(np.float32) * 0.3,
                          device=dev)
    w = torch.as_tensor(rng.uniform(0.5, 400.0, size=(F, M)).astype(
        np.float32), device=dev)
    w[1, M // 2] = 0.0
    w[2, :2] = 0.0
    return obs, w


def _check_fold(rw_k, jw_k, rw_p, jw_p, sim_u, jm_u, obs, w, n_exact):
    """The folded kernel's (rw, jw) against its plain version (sim within
    2e-5 m times the largest weight, jm within 3e-4 of the largest entry),
    and against the unfolded kernel's (sim, jm) times w: bit for bit on rw
    and jw's first `n_exact` columns."""
    torch.cuda.synchronize()
    wmax = float(w.max())
    torch.testing.assert_close(rw_k, rw_p, rtol=0, atol=2e-5 * wmax)
    scale = max(float(jw_p.abs().max()), 1.0)
    torch.testing.assert_close(jw_k, jw_p, rtol=0, atol=3e-4 * scale)
    assert torch.equal(rw_k, (sim_u - obs) * w[..., None])
    jw_u = jm_u * w[..., None, None]
    assert torch.equal(jw_k[..., :n_exact], jw_u[..., :n_exact])
    zero = w == 0
    if bool(zero.any()):
        assert float(jw_k[zero].abs().max()) == 0.0
        assert float(rw_k[zero].abs().max()) == 0.0
    return jw_u


@pytest.mark.parametrize("family,dph,M", CASES)
def test_marker_rows_fold_kernel_matches(dev, family, dph, M):
    """marker_rows<jac,fold> (K17) at E=0: against its plain version, and
    against the unfolded kernel times w bit for bit."""
    model, tables, rng = _tables(family, dph or 6, M, dev)
    F = 37
    x = torch.as_tensor((rng.normal(size=(F, 3 + model.pose_dof)) * 0.5)
                        .astype(np.float32), device=dev)
    theta, trans, _ = mj.kernel_inputs(model, tables, x)
    sm = mj.fk_smalls_plain(theta, tables, True)
    obs, w = _fold_inputs(tables, F, rng, dev)
    rw_k, jw_k = mj.marker_rows_fold(sm, trans, tables, obs, w)
    rw_p, jw_p = mj.marker_rows_fold_plain(sm, trans, tables, obs, w)
    sim_u, jm_u = mj.marker_rows(sm, trans, tables, True)
    _check_fold(rw_k, jw_k, rw_p, jw_p, sim_u, jm_u, obs, w, tables.dof)


def test_marker_rows_ext_fold_kernel_matches(dev):
    """marker_rows<jac,ext,fold> (K18) at N=128, E=8, D=125, bit for bit
    against the unfolded kernel times w, extra columns included."""
    model, tables, rng = _tables("smplh", 24, 46, dev, E=8)
    x = torch.as_tensor((rng.normal(size=(128, tables.dof)) * 0.5)
                        .astype(np.float32), device=dev)
    theta, trans, extra = mj.kernel_inputs(model, tables, x)
    sm = mj.fk_smalls_plain(theta, tables, True, extra)
    obs, w = _fold_inputs(tables, 128, rng, dev)
    rw_k, jw_k = mj.marker_rows_fold(sm, trans, tables, obs, w, extra)
    rw_p, jw_p = mj.marker_rows_fold_plain(sm, trans, tables, obs, w, extra)
    sim_u, jm_u = mj.marker_rows(sm, trans, tables, True, extra)
    assert jw_k.shape == (128, 46, 3, 125)
    _check_fold(rw_k, jw_k, rw_p, jw_p, sim_u, jm_u, obs, w, tables.dof)


@pytest.mark.parametrize("E", [20, 80])
def test_marker_rows_tiled_fold_kernel_matches(dev, E):
    """marker_rows<jac,tiled,fold> (K13) at N=128 on SMPL-X: rw and jw's
    first 3+P columns bit for bit the unfolded kernel's times w, uv the
    unfolded uv times w; the whole folded route's extra columns within
    3e-4 of the largest entry of the unfolded route's times w."""
    model, tables, rng = _tables("smplx", 24, 46, dev, E=E)
    x = torch.as_tensor((rng.normal(size=(128, tables.dof)) * 0.5)
                        .astype(np.float32), device=dev)
    theta, trans, extra = mj.kernel_inputs(model, tables, x)
    jshift, vpshift = mj.extra_shifts(tables, extra)
    sm = mj.fk_smalls_tiled_plain(theta, jshift, tables, True)
    obs, w = _fold_inputs(tables, 128, rng, dev)
    rw_k, jw_k, uv_k = mj.marker_rows_tiled_fold(sm, trans, vpshift, tables,
                                                 obs, w)
    rw_p, jw_p, uv_p = mj.marker_rows_tiled_fold_plain(sm, trans, vpshift,
                                                       tables, obs, w)
    sim_u, jm_u, uv_u = mj.marker_rows_tiled(sm, trans, vpshift, tables, True)
    Dp = tables.dof - E
    _check_fold(rw_k, jw_k[..., :Dp], rw_p, jw_p[..., :Dp], sim_u,
                jm_u[..., :Dp], obs, w, Dp)
    torch.testing.assert_close(uv_k, uv_p, rtol=0,
                               atol=3e-4 * max(float(uv_p.abs().max()), 1.0))
    assert torch.equal(uv_k, uv_u * w[..., None])
    rw, jw = mj.marker_resid_and_wjac(model, tables, x, obs, w)
    sim, jm = mj.marker_sim_and_jacobian(model, tables, x)
    torch.cuda.synchronize()
    jw_u = jm * w[..., None, None]
    assert torch.equal(rw, (sim - obs) * w[..., None])
    assert torch.equal(jw[..., :Dp], jw_u[..., :Dp])
    assert float(jw_u[..., Dp:].abs().max()) > 1e-3
    torch.testing.assert_close(jw[..., Dp:], jw_u[..., Dp:], rtol=0,
                               atol=3e-4 * float(jw_u.abs().max()))


RAGGED_FAMILIES = [("smplh", 24), ("smpl", 6), ("mano", 6), ("smplx", 24)]
# (M, F): marker and frame counts off the kernel's tiles (8 markers a block,
# 2 frames a tile) and off the blocks' frames, which
# `mj.rows_frames_per_block` picks from F and M (on 132 SMs, with the
# Jacobian: 2 at M = 9 up to F = 513, 4 at M = 47 and F = 129, 12 at M = 47
# and F = 517): one marker past a tile at F = 1 and one frame past a tile
# (9, 1), (9, 3), (17, 5); one frame past a block at the 128- and 512-frame
# compaction buckets (47, 129), (9, 513), (47, 517)
RAGGED_SHAPES = [(1, 1), (7, 17), (46, 130), (47, 17), (47, 130), (1, 130),
                 (9, 1), (9, 3), (17, 5), (47, 129), (9, 513), (47, 517)]


@pytest.mark.parametrize("E", [0, 1, 16, 20, 80])
@pytest.mark.parametrize("M,F", RAGGED_SHAPES)
@pytest.mark.parametrize("family,dph", RAGGED_FAMILIES)
def test_marker_rows_ragged_tiles(dev, family, dph, M, F, E):
    """Every marker_rows instantiation of the route E takes (E=0: none,
    1 and 16: inline, 20 and 80: tiled) at marker and frame counts that end
    ragged in the kernel's tiles: <jac> and <sim> against their plain
    versions (sim within 2e-5, jm within 3e-4 of its largest entry, uv
    likewise), and <jac,fold> against its plain version and bit for bit
    against the unfolded kernel's rows times w (tiled: its uv too)."""
    model, tables, rng = _tables(family, dph, M, dev, seed=M + F, E=E)
    x = torch.as_tensor((rng.normal(size=(F, tables.dof)) * 0.5)
                        .astype(np.float32), device=dev)
    theta, trans, extra = mj.kernel_inputs(model, tables, x)
    obs, w = _fold_inputs(tables, F, rng, dev) if F > 2 else (
        torch.as_tensor(rng.normal(size=(F, M, 3)).astype(np.float32),
                        device=dev),
        torch.full((F, M), 3.0, device=dev))
    if tables.route == "tiled":
        jshift, vpshift = mj.extra_shifts(tables, extra)
        Dp = tables.dof - E
        for with_jac in (True, False):
            sm = mj.fk_smalls_tiled_plain(theta, jshift, tables, with_jac)
            k = mj.marker_rows_tiled(sm, trans, vpshift, tables, with_jac)
            p = mj.marker_rows_tiled_plain(sm, trans, vpshift, tables,
                                           with_jac)
            torch.cuda.synchronize()
            torch.testing.assert_close(k[0], p[0], rtol=0, atol=TOL_SIM)
            if with_jac:
                scale = max(float(p[1].abs().max()), 1.0)
                torch.testing.assert_close(k[1][..., :Dp], p[1][..., :Dp],
                                           rtol=0, atol=3e-4 * scale)
                torch.testing.assert_close(
                    k[2], p[2], rtol=0,
                    atol=3e-4 * max(float(p[2].abs().max()), 1.0))
                sim_u, jm_u, uv_u = k
        sm = mj.fk_smalls_tiled_plain(theta, jshift, tables, True)
        rw_k, jw_k, uv_k = mj.marker_rows_tiled_fold(sm, trans, vpshift,
                                                     tables, obs, w)
        rw_p, jw_p, _ = mj.marker_rows_tiled_fold_plain(sm, trans, vpshift,
                                                        tables, obs, w)
        _check_fold(rw_k, jw_k[..., :Dp], rw_p, jw_p[..., :Dp], sim_u,
                    jm_u[..., :Dp], obs, w, Dp)
        assert torch.equal(uv_k, uv_u * w[..., None])
        return
    for with_jac in (True, False):
        sm = mj.fk_smalls_plain(theta, tables, with_jac, extra)
        sim_k, jm_k = mj.marker_rows(sm, trans, tables, with_jac, extra)
        sim_p, jm_p = mj.marker_rows_plain(sm, trans, tables, with_jac, extra)
        torch.cuda.synchronize()
        torch.testing.assert_close(sim_k, sim_p, rtol=0, atol=TOL_SIM)
        if with_jac:
            assert jm_k.shape == (F, M, 3, tables.dof)
            scale = max(float(jm_p.abs().max()), 1.0)
            torch.testing.assert_close(jm_k, jm_p, rtol=0, atol=3e-4 * scale)
            sim_u, jm_u = sim_k, jm_k
    sm = mj.fk_smalls_plain(theta, tables, True, extra)
    rw_k, jw_k = mj.marker_rows_fold(sm, trans, tables, obs, w, extra)
    rw_p, jw_p = mj.marker_rows_fold_plain(sm, trans, tables, obs, w, extra)
    _check_fold(rw_k, jw_k, rw_p, jw_p, sim_u, jm_u, obs, w, tables.dof)


def test_marker_rows_occupancy(dev):
    """Each marker_rows instantiation at the slices' widths (J=52/55,
    featN=459/486, 24 PCA dofs a hand, with the hand blocks and with the
    full hc) keeps at least 16 warps resident on an SM, and the Jacobian
    programs the blocks an SM that `mj.rows_frames_per_block` assumes; the
    library's tile is the one the rule mirrors."""
    lib, _ = kernels.library()
    smem = ctypes.c_int()
    markers, frames = ctypes.c_int(), ctypes.c_int()
    threads = lib.marker_rows_tile(ctypes.byref(markers), ctypes.byref(frames))
    assert (markers.value, frames.value) == (mj.ROWS_MARKERS,
                                             mj.ROWS_TILE_FRAMES)
    widths = {0: (52, 66, 0), 1: (52, 66, 8), 2: (55, 75, 80)}
    for jac, route, fold in [(j, r, f) for j in (1, 0) for r in (0, 1, 2)
                             for f in (0, 1) if j or not f]:
        J, body, E = widths[route]
        for hand_blocks in (2, 1):
            blocks = lib.marker_rows_occupancy(jac, route, fold, J,
                                               9 * (J - 1), body, 48, E,
                                               hand_blocks, ctypes.byref(smem))
            key = (jac, route, fold, hand_blocks, blocks, smem.value)
            assert blocks * threads // 32 >= 16, key
            if jac:
                assert blocks == mj.ROWS_BLOCKS_PER_SM[True], key
    assert lib.marker_rows_occupancy(1, 0, 0, 52, 459, 66, 48, 0, 0,
                                     ctypes.byref(smem)) == 0


@pytest.mark.parametrize("family", ["smplh", "smplx"])
def test_marker_rows_hand_chain_paths(dev, family):
    """The hand-PCA chain's two paths at full width (24 PCA dofs a hand):
    on the block-diagonal hc the per-hand path, against the plain version
    and bit for bit against the full product forced on the same tables;
    with one nonzero entry planted off the hand blocks, the full path (the
    tables find it), against the plain version; each with the Jacobian,
    folded and not."""
    model, tables, rng = _tables(family, 24, 46, dev)
    assert tables.hand_blocks == 2
    planted = model.hands_components.clone()
    planted[3, 50] = 0.05
    bad = dataclasses.replace(model, hands_components=planted)
    mj_bad = mj.prepare_marker_jac_tables(
        bad, *_frame_inputs(bad, dev, rng, 46))
    assert mj_bad.hand_blocks == 1
    F = 37
    for t, m in ((tables, model), (mj_bad, bad)):
        x = torch.as_tensor((rng.normal(size=(F, t.dof)) * 0.5)
                            .astype(np.float32), device=dev)
        theta, trans, _ = mj.kernel_inputs(m, t, x)
        sm = mj.fk_smalls_plain(theta, t, True)
        sim_k, jm_k = mj.marker_rows(sm, trans, t, True)
        sim_p, jm_p = mj.marker_rows_plain(sm, trans, t, True)
        torch.cuda.synchronize()
        torch.testing.assert_close(sim_k, sim_p, rtol=0, atol=TOL_SIM)
        scale = max(float(jm_p.abs().max()), 1.0)
        torch.testing.assert_close(jm_k, jm_p, rtol=0, atol=3e-4 * scale)
        obs, w = _fold_inputs(t, F, rng, dev)
        rw_k, jw_k = mj.marker_rows_fold(sm, trans, t, obs, w)
        rw_p, jw_p = mj.marker_rows_fold_plain(sm, trans, t, obs, w)
        _check_fold(rw_k, jw_k, rw_p, jw_p, sim_k, jm_k, obs, w, t.dof)
        if t is tables:
            full = dataclasses.replace(t, hand_blocks=1)
            _, jm_f = mj.marker_rows(sm, trans, full, True)
            torch.cuda.synchronize()
            assert torch.equal(jm_f, jm_k)


@pytest.mark.parametrize("E", [0, 8, 20])
def test_marker_rows_frames_a_block(dev, monkeypatch, E):
    """Every route's programs give the same bits whatever the frames a
    block (whole tiles: 2, 4, 6, 16 forced, and the rule's choice), at a
    frame count that ends ragged in each."""
    model, tables, rng = _tables("smplh", 24, 46, dev, E=E)
    F = 37
    x = torch.as_tensor((rng.normal(size=(F, tables.dof)) * 0.5)
                        .astype(np.float32), device=dev)
    theta, trans, extra = mj.kernel_inputs(model, tables, x)
    obs, w = _fold_inputs(tables, F, rng, dev)
    rule = mj.rows_frames_per_block

    def rows():
        out = []
        for with_jac in (True, False):
            if tables.route == "tiled":
                # jm's last E columns are extras_cols' to write
                Dp = tables.dof - tables.n_extra
                jshift, vpshift = mj.extra_shifts(tables, extra)
                sm = mj.fk_smalls_tiled_plain(theta, jshift, tables, with_jac)
                s_, j_, u_ = mj.marker_rows_tiled(sm, trans, vpshift, tables,
                                                  with_jac)
                out += [s_, None if j_ is None else j_[..., :Dp], u_]
                if with_jac:
                    r_, j_, u_ = mj.marker_rows_tiled_fold(
                        sm, trans, vpshift, tables, obs, w)
                    out += [r_, j_[..., :Dp], u_]
            else:
                sm = mj.fk_smalls_plain(theta, tables, with_jac, extra)
                out += mj.marker_rows(sm, trans, tables, with_jac, extra)
                if with_jac:
                    out += mj.marker_rows_fold(sm, trans, tables, obs, w,
                                               extra)
        torch.cuda.synchronize()
        return [o for o in out if o is not None]

    ref = rows()
    for nf in (2, 4, 6, 16):
        monkeypatch.setattr(mj, "rows_frames_per_block",
                            lambda *a, nf=nf: nf)
        for a, b in zip(rows(), ref):
            assert torch.equal(a, b), nf
    monkeypatch.setattr(mj, "rows_frames_per_block", rule)


# the tiled extras kernels at ragged shapes: frame counts off the walks,
# extra dims off the 32-wide chunks, the four families' joint counts
EXTRAS_FAMILIES = [("mano", 6), ("smpl", 6), ("smplh", 24), ("smplx", 24)]
EXTRAS_E = [17, 20, 33, 80, 100]
EXTRAS_F = [1, 17, 130, 2048]


@pytest.mark.parametrize("F", EXTRAS_F)
@pytest.mark.parametrize("E", EXTRAS_E)
@pytest.mark.parametrize("family,dph", EXTRAS_FAMILIES)
def test_extras_tangent_ragged(dev, family, dph, E, F):
    """extras_tangent against its plain version on unrelated random q and
    grot (the contract, not only fk_smalls' consistent pair), within 2e-5
    of the largest |datr| (at least 1)."""
    model, tables, rng = _tables(family, dph, 7, dev, seed=E + F, E=E)
    J = tables.num_joints
    q = torch.as_tensor(rng.normal(size=(F, J, 3, 3)).astype(np.float32),
                        device=dev)
    grot = torch.as_tensor(rng.normal(size=(F, J, 3, 3)).astype(np.float32),
                           device=dev)
    datr_k = mj.extras_tangent(q, grot, tables)
    datr_p = mj.extras_tangent_plain(q, grot, tables)
    torch.cuda.synchronize()
    assert datr_k.shape == (F, E, J, 3)
    scale = max(float(datr_p.abs().max()), 1.0)
    torch.testing.assert_close(datr_k, datr_p, rtol=0, atol=2e-5 * scale)


@pytest.mark.parametrize("E", EXTRAS_E)
@pytest.mark.parametrize("M", [1, 7, 46, 47])
@pytest.mark.parametrize("family,dph", EXTRAS_FAMILIES)
def test_extras_cols_ragged(dev, family, dph, M, E):
    """extras_cols against its plain version at F = 1, 17, 130, 2048, within
    3e-4 of the largest |jm| (at least 1), on unweighted and on weighted
    (the folded route's) uv; jm's first D - E columns, a sentinel, stay bit
    for bit and every extra column is written."""
    model, tables, rng = _tables(family, dph, M, dev, seed=M + E, E=E)
    J, D = tables.num_joints, tables.dof
    Dp = D - E
    for F in EXTRAS_F:
        datr = torch.as_tensor(rng.normal(size=(F, E, J, 3))
                               .astype(np.float32) * 0.1, device=dev)
        uv = torch.as_tensor(rng.normal(size=(F, M, mj.UV_WIDTH))
                             .astype(np.float32), device=dev)
        w = torch.as_tensor(rng.uniform(0, 400, size=(F, M))
                            .astype(np.float32), device=dev)
        for u in (uv, (uv * w[..., None]).contiguous()):
            jm = torch.full((F, M, 3, D), 1234.5, device=dev)
            jm[..., Dp:] = float("nan")
            out = mj.extras_cols(datr, u, tables, jm)
            ref = mj.extras_cols_plain(datr, u, tables, jm.clone())
            torch.cuda.synchronize()
            assert out is jm
            assert torch.equal(jm[..., :Dp],
                               torch.full_like(jm[..., :Dp], 1234.5))
            assert torch.isfinite(jm[..., Dp:]).all()
            scale = max(float(ref.abs().max()), 1.0)
            torch.testing.assert_close(jm, ref, rtol=0, atol=3e-4 * scale)


def test_extras_occupancy(dev):
    """Both extras kernels fit the face slice's widths (J=55, E=80, M=46,
    K=2 weights a vertex) and the widest they take (J=64, E=100, M=47,
    K=64): extras_tangent at F=4096 with 8 warps a block, fewer at F=128;
    extras_cols one block of 16 warps an SM, even where 64-joint weight
    lists force more extra-dim chunks (J=64, E=96, K=64)."""
    lib, _ = kernels.library()
    smem, warps = ctypes.c_int(), ctypes.c_int()
    assert lib.extras_tangent_occupancy(4096, 55, 80, ctypes.byref(smem),
                                        ctypes.byref(warps)) >= 1
    assert warps.value == 8 and smem.value <= 232448, (warps, smem)
    assert lib.extras_tangent_occupancy(128, 55, 80, ctypes.byref(smem),
                                        ctypes.byref(warps)) >= 1
    assert 1 <= warps.value < 8
    assert lib.extras_tangent_occupancy(4096, 64, 100, ctypes.byref(smem),
                                        ctypes.byref(warps)) >= 1
    assert lib.extras_tangent_occupancy(4096, 65, 80, ctypes.byref(smem),
                                        ctypes.byref(warps)) == 0
    assert lib.extras_cols_occupancy(46, 55, 80, 2, ctypes.byref(smem)) >= 1
    assert smem.value <= 232448
    for M, J, E, K in ((47, 64, 100, 64), (47, 64, 96, 64)):
        assert lib.extras_cols_occupancy(M, J, E, K, ctypes.byref(smem)) >= 1
        assert smem.value <= 232448, (M, J, E, K, smem)
    assert lib.extras_cols_occupancy(46, 55, 80, 0, ctypes.byref(smem)) == 0


def _pcg_system(D, cond, seed, dev):
    """A direction_test_system case masked and damped as the solver would
    hand it to pcg_direction_batched: (g, B, plin)."""
    g, B, plin, mask, _ = pcg.direction_test_system(128, D, cond, seed=seed,
                                                     device=dev)
    gm, Bm = gauss_newton._masked_system(g, B, mask)
    Bd = gauss_newton._damp(Bm, gauss_newton.DoglegOptions(damping=1e-8))
    return gm.contiguous(), Bd.contiguous(), (plin * mask).contiguous()


@pytest.mark.parametrize("D,cond", [(17, 5.0), (17, 1e2), (117, 5.0),
                                    (117, 1e2), (206, 5.0), (206, 1e2)])
@pytest.mark.parametrize("iters", [24, 128])
def test_pcg_kernel_matches_plain(dev, D, cond, iters):
    """pcg_direction (K19) against the plain version in float64, within 4x
    the float32 plain version's largest distance over the given order and
    two permutations; at cond ~5 also elementwise against the float32 plain
    version; ok equal to the float64 version's wherever its g.p_gn is
    clearly negative."""
    _check_pcg(dev, D, cond, iters)


@pytest.mark.parametrize("D,cond", [(32, 5.0), (33, 1e2), (125, 1e2),
                                    (241, 5.0), (pcg.MAX_DIRECTION_WIDTH, 5.0),
                                    (pcg.MAX_DIRECTION_WIDTH, 1e2)])
@pytest.mark.parametrize("iters", [24, 128])
def test_pcg_kernel_ragged_widths(dev, D, cond, iters):
    """pcg_direction at ragged and the widest widths, held as
    test_pcg_kernel_matches_plain holds it."""
    _check_pcg(dev, D, cond, iters)


def test_direction_shared_memory_matches_wrapper(dev):
    """The launcher's shared memory a block (its occupancy query) is what
    `pcg.direction_smem_bytes` counts, in both modes; it refuses one past
    the widest D."""
    lib, _ = kernels.library()
    for mode in (0, 1):
        for D in (17, 33, 117, 125, 206, 239, 240, pcg.MAX_DIRECTION_WIDTH):
            smem, threads = ctypes.c_int(), ctypes.c_int()
            blocks = lib.dogleg_direction_occupancy(
                mode, D, ctypes.byref(smem), ctypes.byref(threads))
            assert blocks >= 1, (mode, D)
            assert smem.value == pcg.direction_smem_bytes(D), (mode, D)
            assert threads.value % 32 == 0 and threads.value >= D
        assert lib.dogleg_direction_occupancy(
            mode, pcg.MAX_DIRECTION_WIDTH + 1, ctypes.byref(smem),
            ctypes.byref(threads)) == 0


def _check_pcg(dev, D, cond, iters):
    args = _pcg_system(D, cond, D + 1, dev)
    p_k, ok_k = pcg.pcg_direction_batched(*args, iters)
    orders = pcg.pcg_plain_in_orders(*args, iters)
    p_64, ok_64 = pcg.pcg_direction_plain(*(t.double() for t in args), iters)
    torch.cuda.synchronize()
    e_ref = max(float((o[0].double() - p_64).abs().max()) for o in orders)
    torch.testing.assert_close(p_k.double(), p_64, rtol=0,
                               atol=4.0 * e_ref + 1e-6 * float(p_64.abs().max()))
    g64 = args[0].double()
    gp = (g64 * p_64).sum(-1)
    clear = gp < -1e-3 * torch.linalg.vector_norm(g64, dim=-1) * \
        torch.linalg.vector_norm(p_64, dim=-1)
    assert bool(clear.any())
    assert torch.equal(ok_k[clear], ok_64[clear])
    if cond == 5.0:
        torch.testing.assert_close(p_k, orders[0][0], rtol=2e-4, atol=1e-5)
        assert torch.equal(ok_k, orders[0][1])


def test_wrappers_count_and_check(dev):
    kernels.COUNTS.reset()
    model, tables, rng = _tables("smpl", 6, 5, dev)
    x = torch.zeros((3, 3 + model.pose_dof), device=dev)
    mj.marker_sim_and_jacobian(model, tables, x)
    assert kernels.COUNTS.launches[mj.FK_JAC] == 1
    assert kernels.COUNTS.launches[mj.ROWS_JAC] == 1
    assert sum(kernels.COUNTS.plain_cuda.values()) == 0
    model_e, tables_e, _ = _tables("smpl", 6, 5, dev, E=4)
    mj.marker_sim(model_e, tables_e, torch.zeros((3, tables_e.dof), device=dev))
    assert kernels.COUNTS.launches[mj.FK_SIM_EXT] == 1
    assert kernels.COUNTS.launches[mj.ROWS_SIM_EXT] == 1
    model_t, tables_t, _ = _tables("smpl", 6, 5, dev, E=20)
    mj.marker_sim_and_jacobian(model_t, tables_t,
                               torch.zeros((3, tables_t.dof), device=dev))
    mj.marker_sim(model_t, tables_t, torch.zeros((3, tables_t.dof), device=dev))
    for name in (mj.FK_JAC_TILED, mj.TANGENT, mj.ROWS_JAC_TILED, mj.COLS,
                 mj.FK_SIM_TILED, mj.ROWS_SIM_TILED):
        assert kernels.COUNTS.launches[name] == 1, name
    assert sum(kernels.COUNTS.plain_cuda.values()) == 0
    # the extras wrappers refuse what their kernels do not take
    theta_t, _, extra_t = mj.kernel_inputs(
        model_t, tables_t, torch.zeros((3, tables_t.dof), device=dev))
    sm_t = mj.fk_smalls_tiled(theta_t, mj.extra_shifts(tables_t, extra_t)[0],
                              tables_t, True)
    with pytest.raises(ValueError, match="q: expected torch.float32"):
        mj.extras_tangent(sm_t.q.double(), sm_t.grot, tables_t)
    with pytest.raises(ValueError, match="grot: expected a contiguous"):
        mj.extras_tangent(sm_t.q, sm_t.grot.transpose(2, 3), tables_t)
    datr = mj.extras_tangent(sm_t.q, sm_t.grot, tables_t)
    uv = torch.zeros((3, 5, mj.UV_WIDTH), device=dev)
    jm = torch.zeros((3, 5, 3, tables_t.dof), device=dev)
    with pytest.raises(ValueError, match="uv: expected a contiguous"):
        mj.extras_cols(datr, uv.transpose(0, 1).contiguous().transpose(0, 1),
                       tables_t, jm)
    with pytest.raises(ValueError, match="datr: expected shape"):
        mj.extras_cols(datr[:, :-1].contiguous(), uv, tables_t, jm)
    with pytest.raises(ValueError, match="jm: expected torch.float32"):
        mj.extras_cols(datr, uv, tables_t, jm.double())
    mj.extras_cols(datr, uv, tables_t, jm)
    assert kernels.COUNTS.launches[mj.TANGENT] == 2
    assert kernels.COUNTS.launches[mj.COLS] == 2
    assert sum(kernels.COUNTS.plain_cuda.values()) == 0
    theta, _, _ = mj.kernel_inputs(model, tables, x)
    with pytest.raises(ValueError):
        mj.fk_smalls(theta.double(), tables, True)
    with pytest.raises(ValueError):
        mj.fk_smalls(theta.transpose(0, 1).contiguous().transpose(0, 1),
                     tables, True)


def test_fold_and_pcg_wrappers_count_and_check(dev):
    """The folded entry point launches fk_smalls<jac,..> and the folded
    marker rows once each, and never the unfolded ones; the wrappers refuse
    a strided or float64 obs or w, naming it; pcg_direction counts its
    launch."""
    kernels.COUNTS.reset()
    for E, fk, rows in ((0, mj.FK_JAC, mj.ROWS_JAC_FOLD),
                        (4, mj.FK_JAC_EXT, mj.ROWS_JAC_EXT_FOLD),
                        (20, mj.FK_JAC_TILED, mj.ROWS_JAC_TILED_FOLD)):
        model, tables, rng = _tables("smpl", 6, 5, dev, E=E)
        x = torch.zeros((3, tables.dof), device=dev)
        obs, w = _fold_inputs(tables, 3, rng, dev)
        # strided and float64 inputs of the caller are made contiguous here
        mj.marker_resid_and_wjac(model, tables, x, obs.transpose(0, 1)
                                 .contiguous().transpose(0, 1), w.double())
        assert kernels.COUNTS.launches[fk] == 1, fk
        assert kernels.COUNTS.launches[rows] == 1, rows
    for name in (mj.ROWS_JAC, mj.ROWS_JAC_EXT, mj.ROWS_JAC_TILED):
        assert kernels.COUNTS.launches[name] == 0, name
    assert sum(kernels.COUNTS.plain_cuda.values()) == 0
    model, tables, rng = _tables("smpl", 6, 5, dev)
    x = torch.zeros((3, tables.dof), device=dev)
    theta, trans, _ = mj.kernel_inputs(model, tables, x)
    sm = mj.fk_smalls(theta, tables, True)
    obs, w = _fold_inputs(tables, 3, rng, dev)
    strided = obs.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="obs: expected a contiguous"):
        mj.marker_rows_fold(sm, trans, tables, strided, w)
    with pytest.raises(ValueError, match="wrow: expected torch.float32"):
        mj.marker_rows_fold(sm, trans, tables, obs, w.double())
    with pytest.raises(ValueError, match="wrow: expected a contiguous"):
        mj.marker_rows_fold(sm, trans, tables, obs,
                            w.t().contiguous().t())
    g, B, plin = _pcg_system(17, 5.0, 0, dev)
    pcg.pcg_direction_batched(g, B, plin, 24)
    assert kernels.COUNTS.launches[pcg.PCG_KERNEL] == 1
    with pytest.raises(ValueError, match="B: expected torch.float32"):
        pcg.pcg_direction_batched(g, B.double(), plin, 24)


def _family_system(family, dev, seed=0):
    """A small stage-ii problem of an animal family on `dev` and its prior:
    the horse's callable (Mahalanobis rows and leg-bend rows) on the
    contiguous 81-dof slice, the dog's GMM on its gathered 93 dofs."""
    from moshpp_torch.models.body_model import pose_part_ids
    from moshpp_torch.pipeline import stageii
    from moshpp_torch.priors import gmm, mahalanobis
    rng = np.random.default_rng(seed)
    model = make_synthetic_model(family, num_verts=300, seed=4, device=dev)
    betas = (rng.normal(size=16) * 0.3).astype(np.float32)
    vids = rng.choice(model.v_template.shape[0], 20, replace=False)
    lat = (model.v_template[vids] + 0.01).cpu().numpy()
    opts = stageii.StageIIOptions()
    prob = stageii.prepare_stageii_problem(model, betas, lat, opts,
                                           device=dev)
    dim = len(pose_part_ids(family, optimize_toes=True)["body"])
    a = rng.normal(size=(dim, dim)) * 0.1
    cov = 0.04 * (np.eye(dim) + a @ a.T)
    if family == "animal_horse":
        prior = mahalanobis.horse_prior(mahalanobis.mahalanobis_prior_from_arrays(
            rng.normal(size=dim) * 0.1, np.linalg.cholesky(np.linalg.inv(cov)),
            device=dev))
    else:
        prior = gmm.gmm_prior_from_arrays(*gmm._from_moments(
            rng.normal(size=(3, dim)) * 0.1, np.stack([cov] * 3),
            np.asarray([0.2, 0.3, 0.5])), device=dev)
    return prob, opts, prior, rng


@pytest.mark.parametrize("family", ["animal_horse", "animal_dog"])
def test_family_system_card_matches_cpu(dev, family):
    """The stage-ii system (f, g, B) and the trial-point cost with a
    callable prior (the horse: vmap(jacfwd) on the card) and on a gathered
    prior slice (the dog: 93 of 105 dofs), on the card through the kernels
    against the same problem on the CPU, within 1e-4 of each output's
    largest magnitude."""
    from moshpp_torch.pipeline import stageii
    out = {}
    for device in (dev, torch.device("cpu")):
        prob, opts, prior, rng = _family_system(family, device)
        spec = stageii._term_spec(prob, opts, family)
        assert (spec.body_rng is None) == (family == "animal_dog")
        N, D = 37, prob.tables.dof
        M = prob.num_markers
        aux = {"markers": rng.normal(size=(N, M, 3)) * 0.3,
               "mask": (rng.uniform(size=(N, M)) > 0.1).astype(np.float32),
               "wt_data": np.full(N, 400.0 * 46.0 / M),
               "anneal": rng.uniform(1.0, 2.0, N),
               "wt_pose_scale": rng.choice([1.0, 5.0, 10.0], N),
               "velo_anchor": rng.normal(size=(N, D - 3)) * 0.1,
               "velo_on": (np.arange(N) >= 2).astype(np.float32)}
        taux = {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
                for k, v in aux.items()}
        x = torch.as_tensor((rng.normal(size=(N, D)) * 0.3).astype(
            np.float32), device=device)
        system = stageii.make_stageii_system(prob, opts, prior, family)
        kernels.COUNTS.reset()
        f, g, B = system.system_fn(x, taux)
        cost = system.cost_fn(x, taux)
        if device.type == "cuda":
            torch.cuda.synchronize()
            assert kernels.COUNTS.launches[mj.ROWS_JAC] == 1
            assert kernels.COUNTS.launches[mj.ROWS_SIM] == 1
            assert sum(kernels.COUNTS.plain_cuda.values()) == 0
        out[device.type] = [t.cpu() for t in (f, g, B, cost)]
    for name, a, r in zip(("f", "g", "B", "cost"), out["cuda"], out["cpu"]):
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a, r, rtol=0,
                                   atol=1e-4 * float(r.abs().max()),
                                   msg=name)


# ---- stage i ----------------------------------------------------------------
STAGEI_M, STAGEI_F = 12, 3


def _stagei_world(seed=0, frames=STAGEI_F):
    """A small stage-i subject (chip_smoke.stagei_world's generator on a
    300-vertex SMPL+H with dof_per_hand=6, the same 12 of its markers for
    every seed: subjects share one layout) and the model and prior, on the
    CPU."""
    import chip_smoke
    from moshpp_torch.priors.gmm import make_gmm_prior
    model = make_synthetic_model("smplh", num_verts=300, seed=3,
                                 dof_per_hand=6, device="cpu")
    prior = make_gmm_prior(dim=63, num_components=3, seed=1, scale=0.3,
                           device="cpu")
    world = chip_smoke.stagei_world(seed, frames, model, prior)
    keep = np.sort(np.random.default_rng(0).choice(
        chip_smoke.MARKERS, STAGEI_M, replace=False))
    for k in ("vids", "latents"):
        world[k] = world[k][keep]
    world["obs"], world["mask"] = world["obs"][:, keep], world["mask"][:, keep]
    return model, prior, world


def _stagei_call(world, maxiter=40):
    from moshpp_torch.pipeline.stagei import StageIOptions
    M = len(world["vids"])
    return ([f"M{i:02d}" for i in range(M)], world["vids"],
            np.full(M, 0.0095, np.float32), {"body": np.ones(M, bool)},
            StageIOptions(maxiter=maxiter))


def _on(prior, device):
    return dataclasses.replace(prior, **{
        f.name: getattr(prior, f.name).to(device)
        for f in dataclasses.fields(prior)})


def test_stagei_step_card_matches_cpu(dev):
    """chip_smoke.check_stagei_step on a small problem: the stage-i step
    residual, its Jacobian (jacfwd, column by column), g = Jᵀr and B = JᵀJ
    near the init state on the card, each within max(2e-4
    (tests/test_goldens.py's probe tolerance), 4x the CPU float32 step's
    own distance) of the float64 step on the CPU."""
    import chip_smoke
    from moshpp_torch.pipeline import stagei
    model, prior, world = _stagei_world()
    labels, vids, m2b, types, opts = _stagei_call(world)
    ctxs = [stagei.prepare_stagei_context(
        model.to(device), world["obs"], world["mask"], vids, m2b, types,
        opts=opts, prior=_on(prior, device), device=device)
        for device in (torch.device("cpu"), dev)]
    (ctx_c, st_c), (ctx_g, _) = ctxs
    fz = stagei._freeze_stagei_structure(ctx_c, st_c[0], st_c[1])
    chip_smoke.check_stagei_step(ctx_c, fz, ctx_c.lay.pack(*st_c), ctx_g,
                                 dev)


def _stagei_outcome(res):
    return [(r.errs["data_mean_m"], r.markers_latent.cpu().numpy())
            for r in (res if isinstance(res, list) else [res])]


@pytest.mark.parametrize("batched", [False, True])
def test_stagei_solve_card_matches_cpu(dev, batched):
    """A small single (or two-subject batched) stage-i solve on the card
    against the CPU's: each subject's mean data error within max(0.1 mm,
    1.5 x the CPU floor), its latents within max(0.5 mm, 1.5 x the floor),
    the floor being the largest difference between any two of the CPU
    solve and three CPU solves whose observations are moved by 1e-7 m (no
    JAX on the card's machine; chip_smoke.py's phase 6b holds its
    full-width solve to the JAX package's spread instead)."""
    from moshpp_torch.pipeline import stagei
    model, prior, world = _stagei_world()
    labels, vids, m2b, types, opts = _stagei_call(world)
    worlds = [world] + ([_stagei_world(1)[2]] if batched else [])

    def solve(device, noise_seed=None):
        obs = np.stack([w["obs"] for w in worlds])
        if noise_seed is not None:
            obs = obs + 1e-7 * np.random.default_rng(
                noise_seed).standard_normal(obs.shape).astype(np.float32)
        mask = np.stack([w["mask"] for w in worlds])
        kw = dict(opts=opts, prior=_on(prior, device), device=device)
        m = model.to(device)
        if batched:
            res = stagei.mosh_stagei_solve_batched(m, obs, mask, labels,
                                                   vids, m2b, types, **kw)
        else:
            res = stagei.mosh_stagei_solve(m, obs[0], mask[0], labels, vids,
                                           m2b, types, **kw)
        return _stagei_outcome(res)

    cpu = [solve("cpu", s) for s in (None, 7, 8, 9)]
    card = solve(dev)
    for s in range(len(worlds)):
        d_err = lambda a, b: abs(a[s][0] - b[s][0]) * 1e3
        d_lat = lambda a, b: float(np.abs(a[s][1] - b[s][1]).max()) * 1e3
        pairs = [(a, b) for i, a in enumerate(cpu) for b in cpu[i + 1:]]
        lim_err = max(0.1, 1.5 * max(d_err(a, b) for a, b in pairs))
        lim_lat = max(0.5, 1.5 * max(d_lat(a, b) for a, b in pairs))
        assert np.isfinite(card[s][0])
        assert d_err(card, cpu[0]) <= lim_err, (s, d_err(card, cpu[0]))
        assert d_lat(card, cpu[0]) <= lim_lat, (s, d_lat(card, cpu[0]))


def test_stagei_batched_restrictions_on_card(dev):
    """Quirks A and B raise on the card too: subjects of other frame counts
    (ValueError with the restriction's sentence) and a subject whose shared
    context differs (ValueError naming the field)."""
    from moshpp_torch.pipeline import stagei
    model, prior, world = _stagei_world()
    labels, vids, m2b, types, opts = _stagei_call(world)
    m, p = model.to(dev), _on(prior, dev)
    with pytest.raises(ValueError, match="one layout and one frame count"):
        stagei.mosh_stagei_solve_batched(
            m, [world["obs"], world["obs"][:2]],
            [world["mask"], world["mask"][:2]], labels, vids, m2b, types,
            opts=opts, prior=p, device=dev)
    ctx, _ = stagei.prepare_stagei_context(
        m, world["obs"], world["mask"], vids, m2b, types, opts=opts, prior=p,
        device=dev)
    with pytest.raises(ValueError, match="m2b_j"):
        stagei._check_shared([ctx, ctx._replace(m2b_j=ctx.m2b_j + 1.0)])


def test_knn_ties_card_matches_cpu(dev):
    """knn on exact ties (an integer grid, every distance exact in float32)
    on the card: the CPU's indices and distances bit for bit, equal values
    in index order as in the JAX package; nearest_on_mesh's closest points
    through the prefilter within 1e-6 m of the CPU's."""
    from moshpp_torch.ops.knn import knn
    from moshpp_torch.ops.point_mesh import nearest_on_mesh
    from moshpp_torch.models.synthetic import icosphere
    g = torch.arange(5, dtype=torch.float32)
    pts = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    q = torch.tensor([[2, 2, 2], [1.5, 2, 2], [1.5, 1.5, 2], [0, 0, 0]])
    i_c, d_c = knn(q, pts, k=12)
    i_g, d_g = knn(q.to(dev), pts.to(dev), k=12)
    assert torch.equal(i_g.cpu(), i_c) and torch.equal(d_g.cpu(), d_c)
    v, f = icosphere(2)
    v = torch.as_tensor(v.astype(np.float32))
    f = torch.as_tensor(f.astype(np.int64))
    p = torch.tensor([[0.0, 0.0, 1.3], [0.0, 0.0, -0.7], [0.5, 0.5, 0.5]])
    n_c = nearest_on_mesh(p, v, f, prefilter_k=16)
    n_g = nearest_on_mesh(p.to(dev), v.to(dev), f.to(dev), prefilter_k=16)
    torch.testing.assert_close(n_g.point.cpu(), n_c.point, rtol=0, atol=1e-6)


def test_frame_indices_card_match_cpu(dev, tmp_path):
    """select_frame_indices on the card picks the CPU's frame vertices bit
    for bit (knn ranks by coordinate differences, which the card rounds as
    the CPU does) on chip_smoke.py's worlds: the truth of phase 7's head
    session (7b's truth-start pickle) and the true latent markers of phase
    6's eight stage-i subjects; from the canonical vertices each device
    computes itself, as `prepare_stageii_problem` does, and from the
    CPU's."""
    import chip_smoke
    from moshpp_torch.models import make_synthetic_model
    model, prior = chip_smoke.stagei_model("cpu")
    cases = [(model, w["betas"], w["latents"]) for w in (
        chip_smoke.stagei_world(s, 2, model, prior)
        for s in range(chip_smoke.STAGEI_SUBJECTS))]
    world = chip_smoke.head_world(str(tmp_path / "head"),
                                  frames={"walk": 4, "jog": 4})
    truth = np.load(world["truth_fname"])
    head_model = make_synthetic_model("smplh", num_verts=6890, seed=3,
                                      dof_per_hand=24, device="cpu")
    cases.append((head_model, truth["betas"], truth["markers_latent"]))
    for m, betas, latents in cases:
        idx = {}
        for d in ("cpu", dev):
            md = m.to(d)
            bt = torch.as_tensor(betas, device=d)
            can = md.v_template + torch.einsum(
                "vcb,b->vc", md.shapedirs[..., :bt.shape[0]], bt)
            lat = torch.as_tensor(latents, device=d)
            idx[str(d)] = select_frame_indices(can, lat).stacked.cpu()
            if d == "cpu":
                can_c, lat_c = can, lat
        from_cpu = select_frame_indices(can_c.to(dev), lat_c.to(dev))
        assert torch.equal(idx[str(dev)], idx["cpu"])
        assert torch.equal(from_cpu.stacked.cpu(), idx["cpu"])


def test_head_on_the_card_by_default(dev, tmp_path):
    """The head with its default device on tests/test_head.py's world: stage
    i and ii on the card, the main-path kernels launched, numpy in the
    pickles; the card's stage ii within 0.1 mm (mean marker error) of the
    CPU's on the card's stage-i pickle."""
    import pickle
    import shutil
    from moshpp_torch.pipeline import head
    from torch_head_common import base_overrides, build_world
    w = build_world(tmp_path / "world")
    over = base_overrides(w, tmp_path / "card")
    kernels.COUNTS.reset()
    mp = head.run_moshpp_once(over)
    assert mp.device.type == "cuda"
    for name in ("fk_smalls<jac>", "marker_rows<jac>", "marker_rows<sim>",
                 "dogleg_direction"):
        assert kernels.COUNTS.launches[name] > 0, name
    with open(mp.stageii_fname, "rb") as f:
        raw = f.read()
    assert b"torch" not in raw
    card = pickle.loads(raw)
    assert isinstance(card["fullpose"], np.ndarray)
    assert card["fullpose"].shape == (8, 156)
    err_card = card["stageii_debug_details"]["stageii_errs"]["data_mean_m"]
    cpu = head.MoSh(device="cpu", **dict(
        over, **{"dirs.work_base_dir": str(tmp_path / "cpu")}))
    os.makedirs(os.path.dirname(cpu.stagei_fname), exist_ok=True)
    shutil.copy(mp.stagei_fname, cpu.stagei_fname)
    cpu.mosh_stagei()
    cpu.mosh_stageii()
    err_cpu = cpu.stageii_data["stageii_debug_details"]["stageii_errs"][
        "data_mean_m"]
    assert err_card.mean() * 1e3 < 10.0
    assert abs(err_card.mean() - err_cpu.mean()) * 1e3 < 0.1


def test_cli_run_on_the_card(dev, tmp_path):
    """`python -m moshpp_torch run ... --device cuda --npz ...` on
    tests/test_head.py's world."""
    import subprocess
    from torch_head_common import base_overrides, build_world
    w = build_world(tmp_path / "world")
    flags = []
    for k, v in base_overrides(w, tmp_path / "work").items():
        if k != "mocap.fname":
            flags += ["-o", f"{k}={'null' if v is None else v}"]
    npz = tmp_path / "seq0.npz"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-m", "moshpp_torch", "run",
                        w["seq_fnames"][0], "--device", "cuda", "--npz",
                        str(npz), *flags], cwd=repo, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "mean data err" in r.stdout
    assert np.load(npz)["poses"].shape == (8, 156)
