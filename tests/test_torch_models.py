"""The PyTorch port's model layer against the JAX package, on the CPU.

Synthetic model and GMM prior generators must give the same arrays from the
same seed (exact); the forward model and rotation helpers agree to float32
noise; marker frame selection picks the same vertices.
"""

import importlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from moshpp_tpu.models import lbs_forward as jax_lbs_forward
from moshpp_tpu.models import make_synthetic_model as jax_make_model
from moshpp_tpu.ops.lbs_jacobian import (lbs_verts_and_jacobian as
                                         jax_lbs_jac, markers_and_jacobian as
                                         jax_markers_jac)
from moshpp_tpu.ops.marker_transform import (marker_coeffs as jax_coeffs,
                                             select_frame_indices as jax_select)
from moshpp_tpu.ops.surface import vertex_normals as jax_normals
from moshpp_tpu.priors import make_gmm_prior as jax_make_gmm
from moshpp_tpu.priors.gmm import gmm_prior_residual as jax_gmm_residual

from moshpp_torch.models import (lbs_forward, make_synthetic_model,
                                 synthetic_model_arrays)
from moshpp_torch.ops.lbs_jacobian import (lbs_verts_and_jacobian,
                                           markers_and_jacobian)
from moshpp_torch.ops.marker_transform import (MarkerFrameIndices,
                                               marker_coeffs,
                                               select_frame_indices)
from moshpp_torch.ops.surface import vertex_normals
from moshpp_torch.priors.gmm import gmm_prior_residual, make_gmm_prior

torch.set_num_threads(1)

# the package __init__ re-exports the function `rodrigues` under the module's
# name, so import the modules themselves
jrod = importlib.import_module("moshpp_tpu.ops.rodrigues")
trod = importlib.import_module("moshpp_torch.ops.rodrigues")

# the synthetic families (the rigid object has no synthetic generator) with
# the knobs tests/golden_common.py uses
FAMILIES = {
    "smpl": dict(),
    "smplh": dict(dof_per_hand=6),
    "smplx": dict(dof_per_hand=6, num_shape_dirs=20),
    "mano": dict(dof_per_hand=6),
    "animal_horse": dict(),
    "animal_dog": dict(),
}
FIELDS = ("v_template", "shapedirs", "posedirs", "weights", "joint_template",
          "joint_shapedirs", "hands_components", "hands_mean", "faces")


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_synthetic_model_arrays_equal_jax(family):
    jm = jax_make_model(family, num_verts=300, seed=9, **FAMILIES[family])
    arrays = synthetic_model_arrays(family, num_verts=300, seed=9,
                                    **FAMILIES[family])
    tm = make_synthetic_model(family, num_verts=300, seed=9,
                              **FAMILIES[family], device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(arrays[f], np.asarray(getattr(jm, f)),
                                      err_msg=f"{family}.{f}")
        np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                      np.asarray(getattr(jm, f)),
                                      err_msg=f"{family}.{f} tensor")
    assert tm.parents == jm.parents
    assert tm.pose_dof == jm.pose_dof
    assert tm.skin_k == jm.skin_k


@pytest.mark.parametrize("args", [(63, 8, 1, 0.3), (63, 3, 13, 0.3),
                                  (12, 4, 5, 0.2)])
def test_gmm_prior_equals_jax(args):
    dim, k, seed, scale = args
    jp = jax_make_gmm(dim=dim, num_components=k, seed=seed, scale=scale)
    tp = make_gmm_prior(dim=dim, num_components=k, seed=seed, scale=scale,
                        device="cpu")
    for f in ("means", "chols", "sqrt_neg_log_w"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)


def test_gmm_prior_residual_matches_jax():
    """Residual rows, including which component each pose selects."""
    jp = jax_make_gmm(dim=63, num_components=8, seed=1, scale=0.3)
    tp = make_gmm_prior(dim=63, num_components=8, seed=1, scale=0.3,
                        device="cpu")
    rng = np.random.default_rng(2)
    x = np.concatenate([np.asarray(jp.means),
                        rng.normal(size=(8, 63)) * 0.3]).astype(np.float32)
    ref = jax.vmap(lambda xi: jax_gmm_residual(jp, xi))(jnp.asarray(x))
    r = gmm_prior_residual(tp, torch.tensor(x))
    np.testing.assert_allclose(r.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_lbs_forward_matches_jax(family):
    jm = jax_make_model(family, num_verts=300, seed=9, **FAMILIES[family])
    tm = make_synthetic_model(family, num_verts=300, seed=9, **FAMILIES[family],
                              device="cpu")
    rng = np.random.default_rng(3)
    F, P = 4, tm.pose_dof
    pose = (rng.normal(size=(F, P)) * 0.4).astype(np.float32)
    pose[0] = 0.0                                   # zero pose: eps guards
    trans = rng.normal(size=(F, 3)).astype(np.float32)
    betas = (rng.normal(size=10) * 0.3).astype(np.float32)
    ref_v, ref_j = jax.vmap(lambda p, t: jax_lbs_forward(
        jm, p, jnp.asarray(betas), t, want_joints=True))(jnp.asarray(pose),
                                                         jnp.asarray(trans))
    v, j = lbs_forward(tm, torch.tensor(pose), torch.tensor(betas),
                       torch.tensor(trans), want_joints=True)
    np.testing.assert_allclose(v.numpy(), np.asarray(ref_v), atol=1e-5)
    np.testing.assert_allclose(j.numpy(), np.asarray(ref_j), atol=1e-5)


def _rotvecs():
    rng = np.random.default_rng(7)
    v = rng.normal(size=(32, 3)) * 1.2
    v[0] = 0.0                                        # theta = 0
    v[1] = [1e-7, -2e-7, 0.0]                         # theta -> 0
    v[2] = [np.pi - 1e-5, 0.0, 0.0]                   # near pi
    return v.astype(np.float32)


def test_rodrigues_family_matches_jax():
    v = _rotvecs()
    tv = torch.tensor(v)
    R = trod.rodrigues(tv)
    np.testing.assert_allclose(R.numpy(), np.asarray(jrod.rodrigues(v)),
                               atol=1e-5)
    np.testing.assert_allclose(trod.rodrigues_inverse(R).numpy(),
                               np.asarray(jrod.rodrigues_inverse(
                                   jnp.asarray(R.numpy()))), atol=1e-5)
    q = trod.axis_angle_to_quat(tv)
    np.testing.assert_allclose(q.numpy(),
                               np.asarray(jrod.axis_angle_to_quat(v)),
                               atol=1e-5)
    np.testing.assert_allclose(trod.quat_to_axis_angle(q).numpy(),
                               np.asarray(jrod.quat_to_axis_angle(
                                   jnp.asarray(q.numpy()))), atol=1e-5)
    b = np.roll(v, 5, axis=0)
    alpha = np.linspace(0.0, 1.0, 32, dtype=np.float32)[:, None]
    np.testing.assert_allclose(
        trod.slerp_axis_angle(tv, torch.tensor(b), torch.tensor(alpha)).numpy(),
        np.asarray(jrod.slerp_axis_angle(v, b, alpha)), atol=1e-5)


def test_rodrigues_grad_matches_autograd():
    """The hand derivative the kernels use equals autograd of `rodrigues`."""
    v = torch.tensor(_rotvecs()[:8], dtype=torch.float64)
    R, dR = trod.rodrigues_with_grad(v)
    jac = torch.func.vmap(torch.func.jacfwd(trod.rodrigues))(v)
    np.testing.assert_allclose(R.numpy(), trod.rodrigues(v).numpy(), atol=0)
    np.testing.assert_allclose(dR.numpy(), jac.numpy(), atol=1e-9)


def _frame_problem(family):
    """The marker set of tests/golden_common.build_family_problem."""
    rng = np.random.default_rng(101)
    jm = jax_make_model(family, num_verts=300, seed=9, **FAMILIES[family])
    nb = min(16, jm.num_shape_dirs)
    betas = (rng.normal(size=nb) * 0.3).astype(np.float32)
    can_v = np.asarray(jm.v_template) + np.einsum(
        "vcb,b->vc", np.asarray(jm.shapedirs)[..., :nb], betas)
    vn = np.asarray(jax_normals(jnp.asarray(can_v), jm.faces))
    vids = rng.choice(can_v.shape[0], 10, replace=False)
    latents = (can_v[vids] + vn[vids] * 0.0095).astype(np.float32)
    return jm, betas, can_v.astype(np.float32), latents


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_frame_selection_matches_jax(family):
    jm, _, can_v, latents = _frame_problem(family)
    idx_j = jax_select(jnp.asarray(can_v), jnp.asarray(latents))
    can_t, lat_t = torch.tensor(can_v), torch.tensor(latents)
    idx_t = select_frame_indices(can_t, lat_t)
    np.testing.assert_array_equal(idx_t.stacked.numpy(),
                                  np.asarray(idx_j.stacked))
    np.testing.assert_allclose(
        marker_coeffs(can_t, lat_t, idx_t).numpy(),
        np.asarray(jax_coeffs(jnp.asarray(can_v), jnp.asarray(latents),
                              idx_j)), atol=1e-6)
    np.testing.assert_allclose(
        vertex_normals(can_t, torch.as_tensor(np.asarray(jm.faces))).numpy(),
        np.asarray(jax_normals(jnp.asarray(can_v), jm.faces)), atol=1e-6)


@pytest.mark.parametrize("family", ["smplh", "smpl", "mano"])
def test_lbs_jacobian_matches_jax(family):
    """The batched closed-form vertex and marker Jacobians."""
    jm, betas, can_v, latents = _frame_problem(family)
    tm = make_synthetic_model(family, num_verts=300, seed=9, **FAMILIES[family],
                              device="cpu")
    idx_j = jax_select(jnp.asarray(can_v), jnp.asarray(latents))
    coeffs = np.asarray(jax_coeffs(jnp.asarray(can_v), jnp.asarray(latents),
                                   idx_j))
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(4, 3 + tm.pose_dof)) * 0.4).astype(np.float32)

    def one(xi):
        r = jax_lbs_jac(jm, xi[3:], jnp.asarray(betas), xi[:3])
        return jax_markers_jac(r.verts, r.jac, idx_j, jnp.asarray(coeffs))

    sim_r, jm_r = jax.vmap(one)(jnp.asarray(x))
    idx_t = MarkerFrameIndices(*[torch.as_tensor(np.array(c))
                                 for c in idx_j])
    r = lbs_verts_and_jacobian(tm, torch.tensor(x[:, 3:]),
                               torch.tensor(betas), torch.tensor(x[:, :3]))
    sim, jac = markers_and_jacobian(r.verts, r.jac, idx_t,
                                    torch.tensor(coeffs))
    np.testing.assert_allclose(sim.numpy(), np.asarray(sim_r), atol=2e-5)
    scale = np.abs(np.asarray(jm_r)).max()
    np.testing.assert_allclose(jac.numpy(), np.asarray(jm_r),
                               atol=3e-4 * max(scale, 1.0))


@pytest.mark.parametrize("family", ["smplh", "animal_horse"])
def test_forward_kinematics_matches_jax(family):
    """`forward_kinematics` in the JAX package's contract: A (J, 4, 4) with
    the translation reduced by G.j, the posed joints; one frame and a
    batch of frames (the port's leading dims, the JAX function vmapped)."""
    from moshpp_tpu.models import forward_kinematics as jax_fk
    from moshpp_torch.models import forward_kinematics
    jm = jax_make_model(family, num_verts=300, seed=9, **FAMILIES[family])
    rng = np.random.default_rng(5)
    J = len(jm.parents)
    joints = (np.asarray(jm.joint_template)
              + rng.normal(size=(J, 3)) * 0.01).astype(np.float32)
    rv = (rng.normal(size=(3, J, 3)) * 0.5).astype(np.float32)
    rot = np.asarray(jax.vmap(jrod.rodrigues)(jnp.asarray(rv)))
    A_j, p_j = jax.vmap(lambda r: jax_fk(jnp.asarray(joints), r,
                                         jm.parents))(jnp.asarray(rot))
    A_t, p_t = forward_kinematics(torch.tensor(joints), torch.tensor(rot),
                                  jm.parents)
    np.testing.assert_allclose(A_t.numpy(), np.asarray(A_j), atol=1e-5)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=1e-5)
    A1, p1 = forward_kinematics(torch.tensor(joints), torch.tensor(rot[0]),
                                jm.parents)
    np.testing.assert_allclose(A1.numpy(), np.asarray(A_j[0]), atol=1e-5)
    np.testing.assert_allclose(p1.numpy(), np.asarray(p_j[0]), atol=1e-5)


def test_face_normals_match_jax():
    from moshpp_tpu.ops.surface import face_normals as jax_face_normals
    from moshpp_torch.ops import face_normals
    jm = jax_make_model("smplh", num_verts=300, seed=9, dof_per_hand=6)
    v = (np.asarray(jm.v_template) + np.random.default_rng(1).normal(
        size=jm.v_template.shape) * 0.003).astype(np.float32)
    ref = np.asarray(jax_face_normals(jnp.asarray(v), jm.faces))
    out = face_normals(torch.tensor(v), torch.as_tensor(np.asarray(jm.faces)))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
