"""The inputs of one run, made from the configuration, the traffic mix and
the seed: the body model and the hand-PCA and prior files a user would
hand to the program, one subject (betas and latent markers), and a pool of
captures (true motions and their observed markers).

The model, the prior and the subject come from the configuration's
`rest_seed`, as a session runs one model file, one prior, one marker
layout and one subject's stage-i result: the rest geometry (mesh,
skeleton, skinning, joint regressor, marker layout) by numpy; the shape and
pose blend directions, the hand PCA, the GMM and the subject's betas on
the run's device by a `torch.Generator` in a few large calls. The pool of
captures comes from the traffic mix's `capture_seed` by another, as a
lab's archive is fixed. The run's seed draws the order in which the pool
is solved: every seed gets the same work in another order (a seed that
drew the subject or the captures changed the work: §6 of PERF.md). The
observations come from the reference's forward model.
"""

from __future__ import annotations

import dataclasses
import math
import os
import pickle
from typing import List, Optional

import numpy as np
import torch

from reference import Body, Subject, vertex_normals

MOTION_BLOCK = 256      # frames of one block of the motion's AR(1) scan


def icosphere(num_verts: int):
    """(verts (V, 3) float64 on the unit sphere, faces (F, 3) int64): the
    subdivided icosahedron with exactly `num_verts` = 10 4^k + 2
    vertices."""
    t = (1.0 + math.sqrt(5.0)) / 2.0
    v = np.array([(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
                  (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
                  (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)], float)
    f = np.array([(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
                  (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
                  (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
                  (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)])
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    while len(v) < num_verts:
        e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
        key = np.sort(e, axis=1)
        uniq, inv = np.unique(key, axis=0, return_inverse=True)
        mid = v[uniq[:, 0]] + v[uniq[:, 1]]
        mid /= np.linalg.norm(mid, axis=1, keepdims=True)
        m = len(v) + inv.reshape(3, -1)             # midpoints of ab, bc, ca
        a, b, c = f[:, 0], f[:, 1], f[:, 2]
        f = np.concatenate([np.stack([a, m[0], m[2]], 1),
                            np.stack([b, m[1], m[0]], 1),
                            np.stack([c, m[2], m[1]], 1),
                            np.stack([m[0], m[1], m[2]], 1)])
        v = np.concatenate([v, mid])
    if len(v) != num_verts:
        raise ValueError(f"num_verts must be 10 4^k + 2, got {num_verts}")
    return v, f


def rest_geometry(cfg: dict) -> dict:
    """The configuration's fixed model arrays (numpy float64): a mesh
    skinned around a random tree of the family's kinematic table."""
    rng = np.random.default_rng(cfg["rest_seed"])
    parents = cfg["parents"]
    J = len(parents)
    joints = np.zeros((J, 3))
    for k in range(1, J):
        d = rng.normal(size=3)
        joints[k] = (joints[parents[k]]
                     + d / np.linalg.norm(d) * (0.25 * 0.97 ** k + 0.02))
    joints -= joints.mean(0)
    joints *= 0.85 / np.abs(joints).max()
    a = joints[[max(p, 0) for p in parents]]
    seg = joints - a
    seg2 = np.maximum((seg ** 2).sum(-1), 1e-12)

    def bones(p):
        """Distance (V, J) of points p to each bone and the closest points."""
        s = np.clip(((p[:, None] - a) * seg).sum(-1) / seg2, 0.0, 1.0)
        c = a + s[..., None] * seg
        return np.linalg.norm(p[:, None] - c, axis=-1), c

    u, faces = icosphere(cfg["num_verts"])
    V = len(u)
    d, c = bones(1.2 * u)
    radius = 0.09 + 0.05 * np.sin(3.0 * u[:, 0]) * np.cos(2.0 * u[:, 1])
    v = c[np.arange(V), d.argmin(1)] + u * radius[:, None]
    v += rng.normal(size=v.shape) * 3e-4          # no two distances tie
    d, _ = bones(v)
    top = np.argsort(-d / 0.06, axis=1)[:, -2:]
    lw = np.take_along_axis(-d / 0.06, top, 1)
    lw = np.exp(lw - lw.max(1, keepdims=True))
    weights = np.zeros((V, J))
    np.put_along_axis(weights, top, lw / lw.sum(1, keepdims=True), 1)
    k = max(4, V // (J * 8))
    near = np.argsort(np.linalg.norm(joints[:, None] - v[None], axis=-1),
                      axis=1)[:, :k]
    jreg = np.zeros((J, V))
    np.put_along_axis(jreg, near, 1.0 / k, 1)
    kintree = np.stack([np.array([p if p >= 0 else 2 ** 32 - 1
                                  for p in parents], np.int64),
                        np.arange(J)])
    markers = rng.choice(V, cfg["num_markers"], replace=False)
    return dict(v_template=v, faces=faces, weights=weights, J_regressor=jreg,
                kintree_table=kintree, marker_vids=markers)


def _normal(g: torch.Generator, shape, device, scale=1.0) -> torch.Tensor:
    return torch.randn(shape, generator=g, device=device,
                       dtype=torch.float64) * scale


def _smooth_dirs(g, v: torch.Tensor, n: int, freq: float, amp: float):
    """(V, 3, n) smooth random fields amp sin(v F + phase) over the mesh."""
    F = _normal(g, (3, 3 * n), v.device, freq)
    ph = torch.rand((3 * n,), generator=g, device=v.device,
                    dtype=torch.float64) * 2 * math.pi
    return (amp * torch.sin(v @ F + ph)).reshape(-1, 3, n)


def ar1(g, frames: int, dims: int, first: float, decay: float, step: float,
        device) -> torch.Tensor:
    """(frames, dims) float64 x[0] ~ N(0, first^2), x[t] = decay x[t-1] +
    N(0, step^2): the recursion as a scan over blocks of MOTION_BLOCK
    frames, each block one cumulative sum."""
    eps = _normal(g, (frames, dims), device, step)
    eps[0] = _normal(g, (dims,), device, first)
    B = MOTION_BLOCK
    pw = decay ** torch.arange(B, dtype=torch.float64, device=device)
    out = torch.empty_like(eps)
    carry = torch.zeros(dims, dtype=torch.float64, device=device)
    for s in range(0, frames, B):
        e = eps[s:s + B]
        n = e.shape[0]
        # x[s + i] = decay^(i+1) carry + sum_{j <= i} decay^(i-j) e[j]
        acc = torch.cumsum(e / pw[:n, None], 0) * pw[:n, None]
        out[s:s + n] = acc + pw[:n, None] * decay * carry
        carry = out[s + n - 1]
    return out


@dataclasses.dataclass
class World:
    cfg: dict
    traffic: dict
    device: torch.device
    files: dict               # model, hands, prior: paths the program loads
    model_arrays: dict        # the model file's arrays (numpy)
    hand_arrays: Optional[dict]
    betas: np.ndarray         # (num_betas,) float32
    latents: np.ndarray       # (M, 3) float32
    x_true: List[torch.Tensor]  # pool of (F, D) float32 true parameters
    obs: List[torch.Tensor]     # pool of (F, M, 3) float32 observations
    mask: torch.Tensor          # (F, M) bool
    reference: Subject          # float64 forward model of the subject

    @property
    def frames(self) -> int:
        return self.traffic["frames"]

    def extra_cols(self):
        ex = self.cfg["extras"]
        return [] if not ex else list(range(ex["start"],
                                            ex["start"] + ex["count"]))


def seeded_generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


def make_world(cfg: dict, traffic: dict, seed: int, device,
               workdir: str) -> World:
    device = torch.device(device)
    g = seeded_generator(cfg["rest_seed"], device)
    rest = rest_geometry(cfg)
    vt = torch.as_tensor(rest["v_template"], device=device)
    J, S = cfg["num_joints"], cfg["num_shape_dirs"]
    shapedirs = _smooth_dirs(g, vt, S, 2.0, 0.05)
    posedirs = _smooth_dirs(g, vt, 9 * (J - 1), 1.5, 0.01)
    f32 = lambda t: t.to(torch.float32).cpu().numpy()
    model = dict(v_template=rest["v_template"].astype(np.float32),
                 shapedirs=f32(shapedirs), posedirs=f32(posedirs),
                 weights=rest["weights"].astype(np.float32),
                 J_regressor=rest["J_regressor"].astype(np.float32),
                 kintree_table=rest["kintree_table"],
                 f=rest["faces"].astype(np.int32))
    del shapedirs, posedirs
    hands = None
    files = {"model": os.path.join(workdir, "model.npz")}
    if cfg["dof_per_hand"]:
        h = cfg["dof_per_hand"]
        hc = f32(_normal(g, (2, h, 45), device, 0.3))
        hm = f32(_normal(g, (2, 45), device, 0.05))
        hands = dict(componentsl=hc[0], componentsr=hc[1],
                     hands_meanl=hm[0], hands_meanr=hm[1])
        files["hands"] = os.path.join(workdir, "hands.npz")
        np.savez(files["hands"], **hands)
    np.savez(files["model"], **model)

    pr = cfg["prior"]
    K, dim, sc = pr["components"], pr["dim"], pr["scale"]
    A = _normal(g, (K, dim, dim), device, 0.1)
    covars = sc ** 2 * (torch.eye(dim, dtype=torch.float64, device=device)
                        + A @ A.transpose(1, 2))
    means = _normal(g, (K, dim), device, sc * 0.5)
    w = -torch.log(torch.rand((K,), generator=g, device=device,
                              dtype=torch.float64))
    files["prior"] = os.path.join(workdir, "prior.pkl")
    with open(files["prior"], "wb") as fh:
        pickle.dump({"means": means.cpu().numpy(),
                     "covars": covars.cpu().numpy(),
                     "weights": (w / w.sum()).cpu().numpy()}, fh)

    # the subject: betas and latent markers 9.5 mm off the canonical skin
    nb = cfg["num_betas"]
    betas = f32(_normal(g, (nb,), device, cfg["beta_scale"]))
    can = (rest["v_template"] + np.einsum(
        "vcb,b->vc", model["shapedirs"][..., :nb].astype(np.float64), betas))
    faces = torch.as_tensor(rest["faces"])
    nrm = vertex_normals(torch.as_tensor(can), faces).numpy()
    vids = rest["marker_vids"]
    latents = (can[vids] + nrm[vids] * cfg["latent_offset_m"]).astype(
        np.float32)

    body = Body.from_files(model, hands, body_pose_dof=cfg["body_pose_dof"],
                           dof_per_hand=cfg["dof_per_hand"],
                           use_hands_mean=cfg["use_hands_mean"],
                           device=device)
    world = World(cfg=cfg, traffic=traffic, device=device, files=files,
                  model_arrays=model, hand_arrays=hands, betas=betas,
                  latents=latents, x_true=[], obs=[],
                  mask=None, reference=None)
    world.reference = Subject(body, betas, latents, world.extra_cols())

    # the pool of captures, solved in the seed's order
    g = seeded_generator(traffic["capture_seed"], device)
    F, mo = traffic["frames"], traffic["motion"]
    P = cfg["body_pose_dof"] + 2 * cfg["dof_per_hand"]
    ex = cfg["extras"]
    for _ in range(traffic["pool"]):
        pose = ar1(g, F, P, mo["pose0_scale"], mo["pose_ar"], mo["pose_step"],
                   device)
        pose[:, cfg["zero_pose_dofs"]] = 0.0
        trans = torch.cumsum(_normal(g, (F, 3), device, mo["trans_step_m"]), 0)
        parts = [trans, pose]
        if ex:
            a = ex["amplitude"]
            parts.append(ar1(g, F, ex["count"], a, mo["pose_ar"], a / 10,
                             device))
        x = torch.cat(parts, 1).to(torch.float32)
        world.x_true.append(x)
        world.obs.append(reference_markers(world.reference, x).to(
            torch.float32))
    seen = torch.rand((F, cfg["num_markers"]), generator=g, device=device)
    world.mask = seen < traffic["observed"]
    order = torch.argsort(torch.rand(
        (traffic["pool"],), generator=seeded_generator(seed, device),
        device=device)).tolist()
    world.x_true = [world.x_true[i] for i in order]
    world.obs = [world.obs[i] for i in order]
    return world


def reference_markers(subject: Subject, x: torch.Tensor,
                      block: int = 4096) -> torch.Tensor:
    """The reference's markers (N, M, 3) of x (N, D), in blocks of frames."""
    return torch.cat([subject.markers(x[s:s + block])
                      for s in range(0, x.shape[0], block)])
