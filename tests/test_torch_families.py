"""SMPL, MANO and SMPL-X stage-ii solves in the port against the JAX
package, on the CPU, and the pieces of the rigid object's model.

(a) the batched Gauss-Newton system (f, g, B) and the trial-point cost at
    probe points of each family's `golden_common` problem against the JAX
    `make_stageii_system`;
(b) the full CPU solve against a live JAX solve of the same problem, at
    tests/test_goldens.py's outcome tolerances where the JAX solve itself
    holds them against its own solves with 1e-7 m of observation noise
    (`torch_families_common.check_solve`);
(c) the object embedding field for field, and `read_ply` round trips.

The SMAL horse and dog and the object's solve are in
tests/test_torch_animals.py. The JAX solves run in fresh interpreters, one
a family, started as this module begins so they run beside its tests.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from moshpp_tpu.io.ply import read_ply as jax_read_ply
from moshpp_tpu.models.object_model import (
    RigidObjectModel as JaxRigidObject,
    object_as_surface_model as jax_object_as_surface_model)
from moshpp_tpu.models.synthetic import icosphere

from moshpp_torch.io.ply import read_ply, write_ply
from moshpp_torch.models.body_model import lbs_forward
from moshpp_torch.models.object_model import (RigidObjectModel,
                                              load_rigid_object,
                                              object_as_surface_model,
                                              rigid_object_forward)
from moshpp_torch.pipeline import stageii
from torch_families_common import (_MODEL_FIELDS, build_problems,
                                   check_solve, check_system,
                                   start_jax_solves)

torch.set_num_threads(1)

FAMILIES = ("smpl", "mano", "smplx")


@pytest.fixture(scope="module")
def problems():
    return build_problems(FAMILIES)


@pytest.fixture(scope="module", autouse=True)
def jax_solves(tmp_path_factory):
    result, stop = start_jax_solves(FAMILIES,
                                    tmp_path_factory.mktemp("families"))
    yield result
    stop()


@pytest.mark.parametrize("family", FAMILIES)
def test_system_matches_jax(problems, family):
    """(a) at four probe points, with anneal, prior scale and anchors varied
    per frame."""
    fp, (prob, opts, prior) = problems[family]
    if family != "mano":
        assert stageii._term_spec(prob, opts, family).body_rng is not None
    check_system(fp, prob, opts, prior, fp["prior"], family)


@pytest.mark.parametrize("family", FAMILIES)
def test_solve_matches_jax(problems, jax_solves, family):
    """(b)"""
    check_solve(problems, jax_solves, family)


def _scaled_sphere():
    sv, sf = icosphere(2)
    return (sv * np.array([0.11, 0.07, 0.19])).astype(np.float32), sf


def test_object_embedding_matches_jax():
    """(c) the object as a one-joint model equals the JAX embedding field
    for field: zero-width posedirs, one joint, parents (-1,)."""
    sv, sf = _scaled_sphere()
    jm = jax_object_as_surface_model(JaxRigidObject(
        v_template=jnp.asarray(sv), faces=jnp.asarray(sf, jnp.int32)))
    obj = RigidObjectModel(torch.as_tensor(sv), torch.as_tensor(
        sf.astype(np.int64)))
    m = object_as_surface_model(obj)
    for f in _MODEL_FIELDS:
        a, b = getattr(m, f).numpy(), np.asarray(getattr(jm, f))
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("model_type", "parents", "num_betas", "dof_per_hand", "skin_k",
              "num_joints", "pose_dof"):
        assert getattr(m, f) == getattr(jm, f), f
    assert m.posedirs.shape == (sv.shape[0], 3, 0) and m.parents == (-1,)
    # the embedding's one-joint LBS is the rigid forward
    rng = np.random.default_rng(2)
    pose = torch.as_tensor(rng.normal(size=(5, 3)).astype(np.float32))
    trans = torch.as_tensor(rng.normal(size=(5, 3)).astype(np.float32))
    torch.testing.assert_close(
        lbs_forward(m, pose, torch.zeros(1), trans),
        rigid_object_forward(obj, pose, trans), rtol=0, atol=1e-6)


@pytest.mark.parametrize("colors", [False, True])
def test_ply_round_trips(tmp_path, colors):
    """(c) `write_ply` then `read_ply` gives the vertices and faces back,
    and the JAX package's reader reads the same file alike; the object
    loads from it."""
    sv, sf = _scaled_sphere()
    fname = str(tmp_path / "prop.ply")
    cols = (np.random.default_rng(0).uniform(size=sv.shape)
            if colors else None)
    write_ply(fname, sv, sf, vertex_colors=cols)
    v, f = read_ply(fname)
    np.testing.assert_array_equal(v, sv.astype(np.float64))
    np.testing.assert_array_equal(f, sf)
    jv, jf = jax_read_ply(fname)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    obj = load_rigid_object(fname, device="cpu")
    np.testing.assert_array_equal(obj.v_template.numpy(), sv)
    assert obj.faces.dtype == torch.int64


def test_ply_reads_ascii(tmp_path):
    """An ascii PLY with an extra vertex property and a quad-free face
    list."""
    fname = tmp_path / "tri.ply"
    fname.write_text("ply\nformat ascii 1.0\nelement vertex 3\n"
                     "property float x\nproperty float y\nproperty float z\n"
                     "property float confidence\nelement face 1\n"
                     "property list uchar int vertex_indices\nend_header\n"
                     "0 0 0 1\n1 0 0 1\n0 1 0.5 1\n3 0 1 2\n")
    v, f = read_ply(str(fname))
    np.testing.assert_array_equal(v, [[0, 0, 0], [1, 0, 0], [0, 1, 0.5]])
    np.testing.assert_array_equal(f, [[0, 1, 2]])
