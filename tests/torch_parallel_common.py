"""Worlds of the port's multi-device and multi-process tests, built with
the port alone (the processes of tests/test_torch_multihost.py import no
JAX)."""

import numpy as np
import torch

MULTIHOST_FRAMES = 16
MULTIHOST_MARKERS = 10


def multihost_world(device="cpu"):
    """tests/test_multihost.py's world in the port: a 300-vertex SMPL+H
    (6 hand dofs), 10 markers, 16 frames of smooth motion and its options:
    (problem, options, observations, mask)."""
    from moshpp_torch.models import lbs_forward, make_synthetic_model
    from moshpp_torch.ops.marker_transform import (marker_coeffs,
                                                   reconstruct_markers,
                                                   select_frame_indices)
    from moshpp_torch.ops.surface import vertex_normals
    from moshpp_torch.pipeline.stageii import (StageIIOptions,
                                               prepare_stageii_problem)
    M, F = MULTIHOST_MARKERS, MULTIHOST_FRAMES
    rng = np.random.default_rng(0)
    model = make_synthetic_model("smplh", num_verts=300, seed=5,
                                 dof_per_hand=6, device=device)
    betas = (rng.normal(size=10) * 0.3).astype(np.float32)
    bt = torch.as_tensor(betas, device=device)
    can_v = model.v_template + torch.einsum(
        "vcb,b->vc", model.shapedirs[..., :10], bt)
    vn = vertex_normals(can_v, model.faces)
    vids = torch.as_tensor(rng.choice(300, M, replace=False), device=device)
    latents = can_v[vids] + vn[vids] * 0.0095
    idx = select_frame_indices(can_v, latents)
    coeffs = marker_coeffs(can_v, latents, idx)
    P = model.pose_dof
    poses = np.zeros((F, P), np.float32)
    poses[0] = rng.normal(size=P) * 0.1
    for t in range(1, F):
        poses[t] = (0.97 * poses[t - 1]
                    + rng.normal(size=P).astype(np.float32) * 0.02)
    trans = np.cumsum(rng.normal(size=(F, 3)) * 0.004, 0).astype(np.float32)
    obs = reconstruct_markers(
        lbs_forward(model, torch.as_tensor(poses, device=device), bt,
                    torch.as_tensor(trans, device=device)), idx, coeffs)
    opts = StageIIOptions(maxiter=25, smoothing_sweeps=1, anchor_stride=4,
                          num_betas=10, jac_backend="xla")
    prob = prepare_stageii_problem(model, betas, latents.cpu().numpy(),
                                   opts=opts, device=device)
    return prob, opts, obs.cpu().numpy(), np.ones((F, M), bool)


# one rank of the two-process solve: argv rank, world size, port, tests dir,
# repo, output npz
MULTIHOST_WORKER = r"""
import json, sys
sys.path[:0] = [sys.argv[4], sys.argv[5]]
import numpy as np
import torch
torch.set_num_threads(1)
from moshpp_torch.parallel.multihost import (
    distribute_jobs, global_frame_mesh, initialize_multihost,
    mosh_stageii_solve_multihost, multihost_backend)
from torch_parallel_common import multihost_world
rank, n, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
initialize_multihost(f"localhost:{port}", n, rank, device="cpu")
initialize_multihost(f"localhost:{port}", n, rank, device="cpu")  # idempotent
prob, opts, obs, mask = multihost_world()
Fl = obs.shape[0] // n
res = mosh_stageii_solve_multihost(prob, opts, obs[rank * Fl:(rank + 1) * Fl],
                                   mask[rank * Fl:(rank + 1) * Fl],
                                   model_type="smplh", device="cpu")
assert res.trans.shape == (Fl, 3)
from moshpp_torch.pipeline.stageii import stageii_system_probe
probe = stageii_system_probe(prob, opts, obs, mask, model_type="smplh",
                             mesh=global_frame_mesh())
np.savez(sys.argv[6], markers_sim=res.markers_sim, data_err=res.data_err,
         jobs=[j["job"] for j in distribute_jobs([{"job": i}
                                                  for i in range(5)])],
         backend=multihost_backend(),
         shards=global_frame_mesh().shape["frames"],
         **{f"probe_{k}": v.numpy() for k, v in zip("fgB", probe)})
"""
