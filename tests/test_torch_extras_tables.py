"""The tables and the arithmetic of the redesigned tiled extras kernels, on
the CPU.

(a) `prepare_marker_jac_tables`' sparse weight lists (`wnz_j`, `wnz_w`,
    which `csrc/extras_cols.cu` loops over) rebuild the dense `w3` exactly,
    on four families at M = 1, 7, 46, and with a frame vertex whose single
    nonzero weight is its only entry;
(b) every family's `parents` (the port's and the JAX package's, which agree)
    is ordered parents-first, which the tree scan of
    `csrc/extras_tangent.cu` needs, and the tables refuse one that is not;
(c) the two kernels' arithmetic written in PyTorch, a scan down the tree
    and sums over the sparse lists (dv read from `dvt`, its transpose with
    the extra dims last), against the plain versions
    (`extras_tangent_plain`, `extras_cols_plain`) and the JAX package's
    reference of the same functions.

Inputs are made from numpy seeds.
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from moshpp_tpu.models.kintree import DEFAULT_PARENTS as JAX_PARENTS

from moshpp_torch.models import make_synthetic_model
from moshpp_torch.models.kintree import DEFAULT_PARENTS
from moshpp_torch.ops import marker_jac as mj
from moshpp_torch.ops.marker_transform import (marker_coeffs,
                                               select_frame_indices)

FAMILIES = [("smpl", 0), ("smplh", 6), ("smplx", 6), ("mano", 6)]


def _tables(family, dph, M, seed=0, E=0, model=None):
    """(model, frame indices, tables) of a 300-vertex synthetic model (or
    `model`) with M markers and E extra (DMPL) columns after 10 betas."""
    rng = np.random.default_rng(seed)
    if model is None:
        model = make_synthetic_model(family, num_verts=300, seed=4,
                                     dof_per_hand=dph, device="cpu",
                                     num_shape_dirs=10 + E if E else None)
    betas = torch.as_tensor((rng.normal(size=10) * 0.3).astype(np.float32))
    can_v = model.v_template + torch.einsum("vcb,b->vc",
                                            model.shapedirs[..., :10], betas)
    vids = rng.choice(can_v.shape[0], M, replace=False)
    lat = can_v[vids] + 0.01
    idx = select_frame_indices(can_v, lat)
    coeffs = marker_coeffs(can_v, lat, idx)
    return model, idx, mj.prepare_marker_jac_tables(
        model, idx, coeffs, betas, extra_cols=range(10, 10 + E))


def _dense(tables):
    """w3 rebuilt from the sparse lists."""
    M, J = tables.num_markers, tables.num_joints
    w = torch.zeros((M, 3, J), dtype=torch.float32)
    return w.scatter_add_(2, tables.wnz_j.long(), tables.wnz_w)


def _check_lists(tables):
    M, J = tables.num_markers, tables.num_joints
    j, w = tables.wnz_j, tables.wnz_w
    K = j.shape[-1]
    assert j.dtype == torch.int32 and w.dtype == torch.float32
    assert j.shape == w.shape == (M, 3, K)
    nnz = (tables.w3 != 0).sum(-1)
    assert K == max(1, int(nnz.max()))
    assert torch.equal(_dense(tables), tables.w3)
    # each row: its nonzero weights, ascending joints, then (0, 0.0) padding
    for m in range(M):
        for k in range(3):
            n = int(nnz[m, k])
            cols = torch.nonzero(tables.w3[m, k]).flatten()
            assert torch.equal(j[m, k, :n].long(), cols)
            assert torch.equal(w[m, k, :n], tables.w3[m, k, cols])
            assert (j[m, k, n:] == 0).all() and (w[m, k, n:] == 0).all()
    assert int(j.min()) >= 0 and int(j.max()) < J


@pytest.mark.parametrize("M", [1, 7, 46])
@pytest.mark.parametrize("family,dph", FAMILIES)
def test_sparse_weights_rebuild_w3(family, dph, M):
    """The lists hold exactly w3's nonzero weights, zero-padded to the
    largest count, with and without 8 DMPL columns."""
    for E in (0, 8):
        _, _, tables = _tables(family, dph, M, seed=M, E=E)
        _check_lists(tables)


def test_sparse_weights_single_weight():
    """A frame vertex weighted to one joint alone gets a list of one weight
    and padding; a model skinned to at most one joint gives K = 1."""
    model, idx, tables = _tables("smplh", 6, 7, seed=3)
    v = int(idx.stacked[2, 1])
    weights = model.weights.clone()
    weights[v] = 0.0
    weights[v, 5] = 1.0
    one = dataclasses.replace(model, weights=weights)
    _, _, t1 = _tables("smplh", 6, 7, seed=3, model=one)
    _check_lists(t1)
    assert int((t1.wnz_w[2, 1] != 0).sum()) == 1
    assert int(t1.wnz_j[2, 1, 0]) == 5 and float(t1.wnz_w[2, 1, 0]) == 1.0
    hard = torch.nn.functional.one_hot(model.weights.argmax(1),
                                       model.num_joints).float()
    _, _, th = _tables("smplh", 6, 7, seed=3,
                       model=dataclasses.replace(model, weights=hard))
    _check_lists(th)
    assert th.wnz_j.shape[-1] == 1


def test_sparse_weights_function():
    """`sparse_weights` on rows with 0, 1, 2 and 4 nonzero weights."""
    w = np.array([[0, 0, 0, 0, 0], [0, 0, 0.25, 0, 0],
                  [0.5, 0, 0, 0, 0.5], [0.1, 0.2, 0, 0.3, 0.4]], np.float32)
    j, v = mj.sparse_weights(w)
    assert j.shape == v.shape == (4, 4)
    np.testing.assert_array_equal(j, [[0, 0, 0, 0], [2, 0, 0, 0],
                                      [0, 4, 0, 0], [0, 1, 3, 4]])
    assert v.dtype == np.float32
    np.testing.assert_array_equal(v, np.float32([[0, 0, 0, 0],
                                                 [0.25, 0, 0, 0],
                                                 [0.5, 0.5, 0, 0],
                                                 [0.1, 0.2, 0.3, 0.4]]))
    j0, v0 = mj.sparse_weights(np.zeros((2, 3), np.float32))
    assert j0.shape == (2, 1) and not v0.any()


@pytest.mark.parametrize("family", sorted(DEFAULT_PARENTS))
def test_parents_precede_children(family):
    """Every family's kinematic tree, in the port and in the JAX package,
    lists each parent before its children (the tree scans need it)."""
    parents = DEFAULT_PARENTS[family]
    assert tuple(parents) == tuple(JAX_PARENTS[family])
    assert parents[0] == -1
    assert all(p < j for j, p in enumerate(parents))


def test_tables_refuse_children_before_parents():
    """A tree whose joint 3 has the later joint 4 as parent is refused,
    naming the order."""
    model = make_synthetic_model("smpl", num_verts=300, seed=4, device="cpu")
    parents = list(model.parents)
    parents[3] = 4
    bad = dataclasses.replace(model, parents=tuple(parents))
    with pytest.raises(ValueError, match="parent before its children"):
        _tables("smpl", 0, 7, model=bad)


def _scan_tangent(q, grot, tables):
    """extras_tangent as csrc/extras_tangent.cu computes it: S over the
    joints in index order, S[j] = S[parent] + Q_j dtrel[j], then
    datr = S - G_rot[j] djnt[j]."""
    F, J, E = q.shape[0], tables.num_joints, tables.n_extra
    S = torch.zeros((F, E, J, 3))
    for j, p in enumerate(tables.parents):
        y = torch.einsum("fab,eb->fea", q[:, j], tables.dtrel[j])
        S[:, :, j] = y + (S[:, :, p] if p >= 0 else 0.0)
    return S - torch.einsum("fjab,jeb->feja", grot, tables.djnt)


def _list_cols(datr, uv, tables):
    """extras_cols as csrc/extras_cols.cu computes it: wd over the sparse
    lists, then U wd + V dv, dv read from `dvt`; (F, M, 3, E)."""
    F, M = uv.shape[:2]
    wd = torch.zeros((F, M, 3, datr.shape[1], 3))
    for t in range(tables.wnz_j.shape[-1]):
        j = tables.wnz_j[..., t].long()                      # (M, 3)
        w = tables.wnz_w[..., t]
        wd += w[None, :, :, None, None] * datr[:, :, j].permute(0, 2, 3, 1, 4)
    U = uv[..., :27].reshape(F, M, 3, 3, 3)
    V = uv[..., 27:].reshape(F, M, 3, 3, 3)
    return (torch.einsum("fmkcd,fmked->fmce", U, wd)
            + torch.einsum("fmkcz,mkze->fmce", V, tables.dvt))


@pytest.mark.parametrize("family,dph,E", [("smplx", 6, 20), ("smplh", 6, 17),
                                          ("mano", 6, 33), ("smpl", 0, 20)])
def test_kernel_arithmetic_matches_plain(family, dph, E):
    """The scan down the tree and the sums over the sparse lists give the
    plain versions' datr and extra columns (float32 rounding apart), and
    the scan's datr agrees with the JAX package's ancestor-mask product."""
    model, _, tables = _tables(family, dph, 7, seed=E, E=E)
    assert tables.route == "tiled"
    assert torch.equal(tables.dvt, tables.dv.permute(0, 1, 3, 2))
    F, J, M = 5, tables.num_joints, tables.num_markers
    rng = np.random.default_rng(E)
    theta, _, extra = mj.kernel_inputs(model, tables, torch.as_tensor(
        (rng.normal(size=(F, tables.dof)) * 0.5).astype(np.float32)))
    jshift, _ = mj.extra_shifts(tables, extra)
    sm = mj.fk_smalls_tiled_plain(theta, jshift, tables, True)
    datr = mj.extras_tangent_plain(sm.q, sm.grot, tables)
    scan = _scan_tangent(sm.q, sm.grot, tables)
    torch.testing.assert_close(scan, datr, rtol=0, atol=2e-6)
    # the JAX package's form: one (J, J) ancestor-mask product
    anc = jnp.asarray(tables.anc.numpy())
    ref = (jnp.einsum("jk,fkab,keb->feja", anc, sm.q.numpy(),
                      tables.dtrel.numpy())
           - jnp.einsum("fjab,jeb->feja", sm.grot.numpy(),
                        tables.djnt.numpy()))
    np.testing.assert_allclose(scan.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-6)
    uv = torch.as_tensor(rng.normal(size=(F, M, mj.UV_WIDTH))
                         .astype(np.float32))
    jm = torch.full((F, M, 3, tables.dof), 7.0)
    out = mj.extras_cols_plain(datr, uv, tables, jm.clone())
    D0 = tables.dof - E
    assert torch.equal(out[..., :D0], jm[..., :D0])
    torch.testing.assert_close(_list_cols(datr, uv, tables), out[..., D0:],
                               rtol=0, atol=1e-5)
