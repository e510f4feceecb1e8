"""The port's Hopper kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU with the CUDA toolkit (the kernels build with nvcc at
first use); skips elsewhere. The machine with the card has no JAX, so this
file imports none and runs without the suite's conftest:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py -q

Small shapes with ragged frame counts; chip_smoke.py repeats the comparison
at the main path's shapes.
"""

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
from moshpp_torch.solver import pcg  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tables(family, dof_per_hand, M, device, seed=0):
    rng = np.random.default_rng(seed)
    model = make_synthetic_model(family, num_verts=300, seed=4,
                                 dof_per_hand=dof_per_hand, device=device)
    betas = torch.as_tensor((rng.normal(size=10) * 0.3).astype(np.float32),
                            device=device)
    can_v = model.v_template + torch.einsum("vcb,b->vc",
                                            model.shapedirs[..., :10], betas)
    vids = rng.choice(can_v.shape[0], M, replace=False)
    lat = can_v[vids] + 0.01
    idx = select_frame_indices(can_v, lat)
    coeffs = marker_coeffs(can_v, lat, idx)
    return model, mj.prepare_marker_jac_tables(model, idx, coeffs, betas), rng


CASES = [("smplh", 6, 7), ("smplh", 24, 46), ("smpl", 0, 5), ("mano", 6, 7)]


@pytest.mark.parametrize("family,dph,M", CASES)
@pytest.mark.parametrize("with_jac", [True, False])
def test_fk_smalls_kernel_matches_plain(dev, family, dph, M, with_jac):
    model, tables, rng = _tables(family, dph or 6, M, dev)
    x = torch.as_tensor((rng.normal(size=(37, 3 + model.pose_dof)) * 0.5)
                        .astype(np.float32), device=dev)
    x[0] = 0.0
    theta, _ = mj._theta_trans(model, tables, x)
    k = mj.fk_smalls(theta, tables, with_jac)
    p = mj.fk_smalls_plain(theta, tables, with_jac)
    torch.cuda.synchronize()
    for f, a, b in zip(k._fields, k, p):
        if b is None:
            assert a is None
            continue
        torch.testing.assert_close(a, b, rtol=0, atol=2e-5, msg=f)


@pytest.mark.parametrize("family,dph,M", CASES)
@pytest.mark.parametrize("with_jac", [True, False])
def test_marker_rows_kernel_matches_plain(dev, family, dph, M, with_jac):
    model, tables, rng = _tables(family, dph or 6, M, dev)
    x = torch.as_tensor((rng.normal(size=(37, 3 + model.pose_dof)) * 0.5)
                        .astype(np.float32), device=dev)
    theta, trans = mj._theta_trans(model, tables, x)
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


@pytest.mark.parametrize("D,cond", [(17, 5.0), (17, 1e2), (117, 5.0),
                                    (117, 1e2), (117, 1e3)])
@pytest.mark.parametrize("iters", [24, 128])
def test_direction_kernel_matches_plain(dev, D, cond, iters):
    """Against the plain version in float64, within 4x the float32 plain
    version's own distance from it; at cond ~5 also elementwise against the
    float32 plain version. At D=117, cond >= 1e2, 24 iterations have not
    converged, so p differs between 24 and 128 iterations; at D=17, 128
    iterations run far past convergence, through the breakdown guards."""
    args = pcg.direction_test_system(128, D, cond, seed=D, device=dev)
    out_k = pcg.dogleg_direction_batched(*args, iters, 1e-8)
    out_p = pcg.dogleg_direction_plain(*args, iters, 1e-8)
    out_64 = pcg.dogleg_direction_plain(*(t.double() for t in args), iters, 1e-8)
    torch.cuda.synchronize()
    for k, p, r in zip(out_k, out_p, out_64):
        e_p = float((p.double() - r).abs().max())
        torch.testing.assert_close(k.double(), r, rtol=0,
                                   atol=4.0 * e_p + 1e-6 * float(r.abs().max()))
    if cond == 5.0:
        torch.testing.assert_close(out_k[0], out_p[0], rtol=2e-4, atol=1e-5)
        torch.testing.assert_close(out_k[1], out_p[1], rtol=2e-4, atol=1e-5)
        torch.testing.assert_close(out_k[2], out_p[2], rtol=2e-3, atol=1e-6)
    if D == 117 and cond >= 1e2:
        other = pcg.dogleg_direction_plain(*(t.double() for t in args),
                                           24 if iters == 128 else 128, 1e-8)
        e_p = float((out_p[0].double() - out_64[0]).abs().max())
        assert float((other[0] - out_64[0]).abs().max()) > 10.0 * e_p


def test_wrappers_count_and_check(dev):
    kernels.COUNTS.reset()
    model, tables, rng = _tables("smpl", 6, 5, dev)
    x = torch.zeros((3, 3 + model.pose_dof), device=dev)
    mj.marker_sim_and_jacobian(model, tables, x)
    assert kernels.COUNTS.launches[mj.FK_JAC] == 1
    assert kernels.COUNTS.launches[mj.ROWS_JAC] == 1
    assert sum(kernels.COUNTS.plain_cuda.values()) == 0
    theta, _ = mj._theta_trans(model, tables, x)
    with pytest.raises(ValueError):
        mj.fk_smalls(theta.double(), tables, True)
    with pytest.raises(ValueError):
        mj.fk_smalls(theta.transpose(0, 1).contiguous().transpose(0, 1),
                     tables, True)
