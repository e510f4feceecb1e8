"""The port's stage-ii system probe, marker transport, marker-Jacobian
builder and report term names against the JAX package's, on the CPU.

(a) `stageii_system_probe` (one batched (f, g, B) at the rigid init)
    against JAX's on the same golden problems and observations, at
    tests/test_torch_residual.py's bar (f to rtol 1e-5, g and B to 5e-4 of
    their largest magnitude);
(b) with a mesh (`FrameMesh(["cpu"] * 2)`, and 3 shards at a frame count
    they do not divide) against the unsharded probe at rel <= 1e-5, the
    JAX package's bar (__graft_entry__.py:155-160), at E=0, 4 inline DMPLs
    and 20 tiled ones (__graft_entry__.py:184-209); the real frames do not
    depend on how the frames are padded;
(c) `transport_markers` against JAX's, to 1e-6 m;
(d) `build_marker_jacobian_fn` against JAX's (Pallas in interpret mode)
    on tests/test_pallas_jac.py's case, to that file's tolerances;
(e) `report_arrays_spec` equals JAX's.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from moshpp_torch.parallel import frame_mesh, pad_frames
from moshpp_torch.pipeline import stageii

torch.set_num_threads(1)

F_RTOL = 1e-5
GB_ATOL = 5e-4
SHARD_REL = 1e-5
TRANSPORT_ATOL_M = 1e-6
SIM_ATOL, JM_ATOL = 2e-5, 3e-4      # tests/test_pallas_jac.py:69-72


def _rel(a, b) -> float:
    """max |a - b| / max |b|."""
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


@pytest.mark.parametrize("family", ["smplh", "animal_horse"])
def test_probe_matches_jax(family):
    """(a) the golden problem of the family, all its frames."""
    from golden_common import build_family_problem
    from moshpp_tpu.pipeline.stageii import stageii_system_probe as jax_probe
    from torch_families_common import port_problem
    fp = dict(build_family_problem(family), family=family)
    prob, opts, prior = port_problem(fp)
    ref = jax_probe(fp["prob"], fp["opts"], fp["obs"], fp["mask"],
                    prior=fp["prior"], model_type=family)
    out = stageii.stageii_system_probe(prob, opts, fp["obs"], fp["mask"],
                                       prior=prior, model_type=family)
    f_ref, g_ref, B_ref = (np.asarray(r) for r in ref)
    f, g, B = (t.numpy() for t in out)
    assert B.shape == B_ref.shape == (fp["obs"].shape[0],) + g.shape[1:] * 2
    np.testing.assert_allclose(f, f_ref, rtol=F_RTOL)
    np.testing.assert_allclose(g, g_ref, atol=GB_ATOL * np.abs(g_ref).max())
    np.testing.assert_allclose(B, B_ref, atol=GB_ATOL * np.abs(B_ref).max())


def _tiny(frames, n_dmpl):
    """__graft_entry__'s `_tiny_problem` in the port (300 vertices, 46
    markers, smooth motion), with `n_dmpl` DMPLs a frame (more than 16
    take the tiled route)."""
    import chip_smoke
    opts = stageii.StageIIOptions(optimize_dynamics=bool(n_dmpl),
                                  num_dmpls=n_dmpl or 8)
    return chip_smoke.synthetic_problem(
        frames, "cpu", opts, num_verts=300, dof_per_hand=6, model_seed=5,
        prior_components=3, prior_seed=2, beta_scale=0.3, pose0_scale=0.12,
        num_shape_dirs=16 + n_dmpl if n_dmpl else None)


@pytest.mark.parametrize("n_dmpl", [0, 4, 20])
@pytest.mark.parametrize("shards,frames", [(2, 16), (3, 13)])
def test_sharded_probe_matches_unsharded(n_dmpl, shards, frames):
    """(b) the sharded probe against the unsharded one, and the unsharded
    probe of frames padded with all-missing ones (`pad_frames`, the other
    padding) on the real frames."""
    bp = _tiny(frames, n_dmpl)
    args = (bp["prob"], bp["opts"])
    kw = dict(prior=bp["prior"], model_type="smplh")
    assert bp["prob"].tables.n_extra == n_dmpl
    if n_dmpl:
        assert bp["prob"].tables.route == ("tiled" if n_dmpl > 16
                                           else "ext")
    u = stageii.stageii_system_probe(*args, bp["obs"], bp["mask"], **kw)
    s = stageii.stageii_system_probe(*args, bp["obs"], bp["mask"], **kw,
                                     mesh=frame_mesh(["cpu"] * shards))
    obs_p, mask_p, _ = pad_frames(bp["obs"].numpy(), bp["mask"].numpy(),
                                  shards)
    assert obs_p.shape[0] % shards == 0 and obs_p.shape[0] >= frames
    p = stageii.stageii_system_probe(*args, obs_p, mask_p, **kw)
    for name, a, b, c in zip("fgB", s, u, p):
        assert a.shape == b.shape and a.shape[0] == frames
        assert _rel(a, b) <= SHARD_REL, (name, _rel(a, b))
        assert _rel(c[:frames], b) <= SHARD_REL, (name, _rel(c[:frames], b))


def _marker_case(model_type, rng, num_markers=7, dof_per_hand=6):
    """tests/test_pallas_jac.py's `_problem` in both packages: (JAX model,
    port model, betas, JAX idx, coeffs, the port's idx and coeffs)."""
    from moshpp_tpu.models import make_synthetic_model as jax_make_model
    from moshpp_tpu.ops.marker_transform import (marker_coeffs,
                                                 select_frame_indices)
    from moshpp_tpu.ops.surface import vertex_normals
    from moshpp_torch.ops.marker_transform import MarkerFrameIndices
    from torch_families_common import port_model
    model = jax_make_model(model_type, num_verts=300, seed=4,
                           dof_per_hand=dof_per_hand)
    nb = min(10, model.num_shape_dirs)
    betas = (rng.normal(size=nb) * 0.3).astype(np.float32)
    can_v = np.asarray(model.v_template) + np.einsum(
        "vcb,b->vc", np.asarray(model.shapedirs)[..., :nb], betas)
    vn = np.asarray(vertex_normals(jnp.asarray(can_v), model.faces))
    vids = rng.choice(can_v.shape[0], num_markers, replace=False)
    latents = (can_v[vids] + vn[vids] * 0.0095).astype(np.float32)
    idx = select_frame_indices(jnp.asarray(can_v), jnp.asarray(latents))
    coeffs = marker_coeffs(jnp.asarray(can_v), jnp.asarray(latents), idx)
    tidx = MarkerFrameIndices(*[torch.as_tensor(np.array(c)) for c in idx])
    return (model, port_model(model), betas, idx, coeffs, tidx,
            torch.as_tensor(np.array(coeffs)), can_v, latents)


@pytest.mark.parametrize("model_type", ["smplh", "smplx"])
def test_transport_markers_matches_jax(model_type):
    """(c) latent markers carried onto 3 posed bodies."""
    from moshpp_tpu.models import lbs_forward
    from moshpp_tpu.ops.marker_transform import transport_markers as jax_tm
    from moshpp_torch.ops.marker_transform import transport_markers
    rng = np.random.default_rng(42)
    jm, _, betas, idx, _, tidx, _, can_v, latents = _marker_case(
        model_type, rng)
    x = (rng.normal(size=(3, 3 + jm.pose_dof)) * 0.4).astype(np.float32)
    posed = np.stack([np.asarray(lbs_forward(jm, jnp.asarray(xi[3:]),
                                             jnp.asarray(betas),
                                             jnp.asarray(xi[:3])))
                      for xi in x])
    ref = np.stack([np.asarray(jax_tm(jnp.asarray(can_v), jnp.asarray(latents),
                                      jnp.asarray(p), idx)) for p in posed])
    out = transport_markers(torch.as_tensor(can_v, dtype=torch.float32),
                            torch.as_tensor(latents), torch.as_tensor(posed),
                            tidx)
    assert out.shape == ref.shape == (3, len(latents), 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=TRANSPORT_ATOL_M)


@pytest.mark.parametrize("model_type", ["smplh", "smplx", "animal_horse"])
def test_marker_jacobian_fn_matches_jax(model_type):
    """(d) tests/test_pallas_jac.py::test_matches_analytic_xla's inputs
    (its rng fixture's seed, F=5, x ~ 0.4 N(0, 1)) on three of its five
    families (tests/test_torch_marker_jac.py holds the kernels' plain
    versions to the Pallas kernels on the others)."""
    from moshpp_tpu.ops.pallas_marker_jac import (
        build_marker_jacobian_fn as jax_build)
    from moshpp_torch.ops.marker_jac import build_marker_jacobian_fn
    rng = np.random.default_rng(42)
    jm, tm, betas, idx, coeffs, tidx, tcoeffs, _, _ = _marker_case(
        model_type, rng)
    x = (rng.normal(size=(5, 3 + jm.pose_dof)) * 0.4).astype(np.float32)
    sim_r, jm_r = jax_build(jm, idx, coeffs, betas,
                            interpret=True)(jnp.asarray(x))
    sim, jmat = build_marker_jacobian_fn(tm, tidx, tcoeffs,
                                         torch.as_tensor(betas))(
        torch.as_tensor(x))
    sim_r, jm_r = np.asarray(sim_r), np.asarray(jm_r)
    assert sim.shape == sim_r.shape and jmat.shape == jm_r.shape
    np.testing.assert_allclose(sim.numpy(), sim_r, atol=SIM_ATOL)
    np.testing.assert_allclose(jmat.numpy(), jm_r,
                               atol=JM_ATOL * max(np.abs(jm_r).max(), 1.0))


def test_report_arrays_spec_matches_jax():
    """(e) the term names of every case of tests/test_torch_residual.py,
    and the alias is the port's `report_term_names`."""
    from moshpp_tpu.pipeline.stageii import report_arrays_spec as jax_spec
    from test_torch_residual import CASES, _setup
    assert stageii.report_arrays_spec is stageii.report_term_names
    for name in CASES:
        c = _setup(name)
        ours = stageii.report_arrays_spec(c["prob"], c["opts"], c["prior"],
                                          c["family"])
        ref = jax_spec(c["jprob"], c["jopts"], c["jprior"], c["family"])
        assert ours == tuple(ref), name
