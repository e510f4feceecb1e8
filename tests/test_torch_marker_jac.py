"""The port's marker functions (`moshpp_torch.ops.marker_jac`) against the
JAX package's fused Pallas kernels, run in interpret mode on the CPU.

On CPU tensors the wrappers run the plain PyTorch versions of the Hopper
kernels, so this pins those versions (and the table layout the kernels
share) to what the TPU kernels compute. Tolerances are those of
tests/test_pallas_jac.py.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from moshpp_tpu.models import make_synthetic_model as jax_make_model
from moshpp_tpu.ops.marker_transform import (marker_coeffs as jax_coeffs,
                                             select_frame_indices as jax_select)
from moshpp_tpu.ops.pallas_marker_jac import (
    marker_sim as jax_marker_sim,
    marker_sim_and_jacobian as jax_marker_sim_and_jacobian,
    prepare_marker_jac_tables as jax_prepare_tables)
from moshpp_tpu.ops.surface import vertex_normals as jax_normals

from moshpp_torch import kernels
from moshpp_torch.models import make_synthetic_model
from moshpp_torch.ops.marker_jac import (FK_JAC, ROWS_JAC,
                                         marker_sim, marker_sim_and_jacobian,
                                         prepare_marker_jac_tables)
from moshpp_torch.ops.marker_transform import MarkerFrameIndices

torch.set_num_threads(1)


def _problem(family, num_markers, dof_per_hand=6, seed=4):
    rng = np.random.default_rng(seed)
    jm = jax_make_model(family, num_verts=300, seed=4,
                        dof_per_hand=dof_per_hand)
    tm = make_synthetic_model(family, num_verts=300, seed=4,
                              dof_per_hand=dof_per_hand, device="cpu")
    nb = min(10, jm.num_shape_dirs)
    betas = (rng.normal(size=nb) * 0.3).astype(np.float32)
    can_v = np.asarray(jm.v_template) + np.einsum(
        "vcb,b->vc", np.asarray(jm.shapedirs)[..., :nb], betas)
    vn = np.asarray(jax_normals(jnp.asarray(can_v), jm.faces))
    vids = rng.choice(can_v.shape[0], num_markers, replace=False)
    latents = (can_v[vids] + vn[vids] * 0.0095).astype(np.float32)
    idx = jax_select(jnp.asarray(can_v), jnp.asarray(latents))
    coeffs = jax_coeffs(jnp.asarray(can_v), jnp.asarray(latents), idx)
    jt = jax_prepare_tables(jm, idx, coeffs, betas)
    tt = prepare_marker_jac_tables(
        tm, MarkerFrameIndices(*[torch.as_tensor(np.array(c)) for c in idx]),
        torch.as_tensor(np.array(coeffs)), torch.as_tensor(betas))
    return jm, jt, tm, tt, rng


def _check(sim, jmat, sim_r, jm_r):
    np.testing.assert_allclose(sim.numpy(), np.asarray(sim_r), atol=2e-5)
    scale = np.abs(np.asarray(jm_r)).max()
    np.testing.assert_allclose(jmat.numpy(), np.asarray(jm_r),
                               atol=3e-4 * max(scale, 1.0))


@pytest.mark.parametrize("family,num_markers", [("smplh", 7), ("smpl", 7),
                                                ("mano", 7), ("smpl", 5),
                                                ("smplx", 7)])
def test_sim_and_jacobian_match_pallas(family, num_markers):
    jm, jt, tm, tt, rng = _problem(family, num_markers)
    x = (rng.normal(size=(5, 3 + tm.pose_dof)) * 0.4).astype(np.float32)
    x[0] = 0.0                                     # zero pose in the batch
    sim_r, jm_r = jax_marker_sim_and_jacobian(jm, jt, jnp.asarray(x),
                                              interpret=True)
    sim, jmat = marker_sim_and_jacobian(tm, tt, torch.tensor(x))
    assert sim.shape == (5, num_markers, 3)
    assert jmat.shape == (5, num_markers, 3, 3 + tm.pose_dof)
    _check(sim, jmat, sim_r, jm_r)


def test_zero_pose_matches_pallas():
    """Zero pose exercises the eps guards of the Rodrigues derivative."""
    jm, jt, tm, tt, _ = _problem("smplh", 7)
    x = np.zeros((2, 3 + tm.pose_dof), np.float32)
    sim_r, jm_r = jax_marker_sim_and_jacobian(jm, jt, jnp.asarray(x),
                                              interpret=True)
    sim, jmat = marker_sim_and_jacobian(tm, tt, torch.tensor(x))
    np.testing.assert_allclose(sim.numpy(), np.asarray(sim_r), atol=2e-5)
    np.testing.assert_allclose(jmat.numpy(), np.asarray(jm_r), atol=3e-4)


@pytest.mark.parametrize("family", ["smplh", "smpl", "mano", "smplx"])
def test_sim_matches_pallas(family):
    jm, jt, tm, tt, rng = _problem(family, 7)
    x = (rng.normal(size=(5, 3 + tm.pose_dof)) * 0.4).astype(np.float32)
    sim_r = jax_marker_sim(jm, jt, jnp.asarray(x), interpret=True)
    sim = marker_sim(tm, tt, torch.tensor(x))
    np.testing.assert_allclose(sim.numpy(), np.asarray(sim_r), atol=2e-5)
    sim_full, _ = marker_sim_and_jacobian(tm, tt, torch.tensor(x))
    np.testing.assert_allclose(sim.numpy(), sim_full.numpy(), atol=1e-6)


def test_cpu_tensors_take_the_plain_versions():
    """CPU inputs never reach the kernel launcher, and leave the plain
    versions' on-CUDA counters at zero."""
    _, _, tm, tt, rng = _problem("smpl", 5)
    kernels.COUNTS.reset()
    x = torch.tensor((rng.normal(size=(3, 3 + tm.pose_dof)) * 0.3)
                     .astype(np.float32))
    marker_sim_and_jacobian(tm, tt, x)
    assert kernels.COUNTS.launches[FK_JAC] == 0
    assert kernels.COUNTS.launches[ROWS_JAC] == 0
    assert sum(kernels.COUNTS.plain_cuda.values()) == 0


def test_extra_dims_raise():
    """x wider than the tables' extra dims is refused, and so is an extra
    column past the model's shapedirs width."""
    _, _, tm, tt, _ = _problem("smpl", 5)
    with pytest.raises(ValueError):
        marker_sim(tm, tt, torch.zeros((2, 3 + tm.pose_dof + 4)))
    with pytest.raises(ValueError):
        prepare_marker_jac_tables(tm, MarkerFrameIndices(*tt.cf.new_zeros(
            (3, 5), dtype=torch.long)), tt.cf, torch.zeros(10),
            extra_cols=range(tm.num_shape_dirs - 2, tm.num_shape_dirs + 1))
