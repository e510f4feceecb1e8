"""The program under test, `moshpp_torch`, entered as a user enters it: the
model, hand-PCA and prior files through its loaders, the subject through
`prepare_stageii_problem`, each capture through `mosh_stageii_solve`.

This is the one module of the benchmark that imports the program. What it
reads back: each solve's outputs and `host_syncs`, the kernel launch
counters (`kernels.COUNTS`), and, in a traced run, the iterations of each
dogleg solve (`batched_system_solve`'s `SolveResult.iterations`, summed per
call by a span the benchmark puts around the solver layer).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List

import numpy as np
import torch

OUTPUTS = ("trans", "pose", "extra", "fullpose", "markers_sim")


@dataclasses.dataclass
class SolveCall:
    """One dogleg solve inside a stage-ii solve: its batch, its direction's
    CG iterations, and the frame-iterations it ran (a device scalar until
    read)."""
    frames: int
    cg_iters: int
    linear_solver: str
    frame_iters: object


class Program:
    def __init__(self, world, device):
        from moshpp_torch import kernels
        from moshpp_torch.io.model_loader import load_surface_model
        from moshpp_torch.pipeline import stageii
        from moshpp_torch.priors.gmm import load_gmm_prior

        cfg = world.cfg
        self.device = torch.device(device)
        self._kernels = kernels
        self._stageii = stageii
        if self.device.type == "cuda":
            kernels.library()             # nvcc in a checkout's first run
        self.model_type = cfg["model_type"]
        model = load_surface_model(
            world.files["model"], surface_model_type=self.model_type,
            pose_hand_prior_fname=world.files.get("hands"),
            use_hands_mean=cfg["use_hands_mean"],
            dof_per_hand=cfg["dof_per_hand"], num_betas=cfg["num_betas"],
            device=self.device)
        self.prior = load_gmm_prior(world.files["prior"],
                                    npose=cfg["prior"]["dim"],
                                    device=self.device)
        sv = dict(cfg["solver"])
        ex = cfg["extras"]
        if ex and ex["kind"] == "expressions":
            sv.update(num_expressions=ex["count"], expr_start=ex["start"])
        elif ex:
            sv.update(optimize_dynamics=True, num_dmpls=ex["count"])
        self.opts = stageii.StageIIOptions(num_betas=cfg["num_betas"], **sv)
        self.problem = stageii.prepare_stageii_problem(
            model, world.betas, world.latents, self.opts, device=self.device)
        self.calls: List[SolveCall] = []

    def solve(self, obs: torch.Tensor, mask: torch.Tensor) -> dict:
        """One capture solved; its outputs read to the host."""
        res = self._stageii.mosh_stageii_solve(
            self.problem, self.opts, obs, mask, self.prior, self.model_type,
            device=self.device)
        out = {k: getattr(res, k).cpu() for k in OUTPUTS}
        out["host_syncs"] = int(res.host_syncs)
        return out

    @property
    def counts(self):
        return self._kernels.COUNTS

    @contextlib.contextmanager
    def solver_spans(self):
        """Record every dogleg solve's batch, CG iterations and
        frame-iterations into `self.calls` while inside."""
        inner = self._stageii.batched_system_solve

        def spanned(system, x0, aux, options, *args, **kwargs):
            r = inner(system, x0, aux, options, *args, **kwargs)
            self.calls.append(SolveCall(
                int(x0.shape[0]), int(options.cg_iters),
                options.linear_solver,
                r.iterations.to(torch.int64).sum()))
            return r

        self._stageii.batched_system_solve = spanned
        try:
            yield
        finally:
            self._stageii.batched_system_solve = inner

    def release(self) -> None:
        """Drop the program's state from the device."""
        self.problem = self.prior = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def structure(world, route: str) -> dict:
    """The shapes the operation counts read, worked out from the
    configuration and the reference's marker frames: markers, joints, pose
    features, hand PCA, extras, the kernels' `route` (the program's), and
    per frame vertex its nonzero skinning weights and its joints'
    ancestors."""
    cfg = world.cfg
    ref = world.reference
    parents = cfg["parents"]
    J = len(parents)
    anc = []
    for j in range(J):
        s, k = set(), j
        while k >= 0:
            s.add(k)
            k = parents[k]
        anc.append(s)
    w = world.model_arrays["weights"]
    fv = ref.frame.cpu().numpy()
    nnz, nanc = [], []
    for m in range(fv.shape[0]):
        for v in fv[m]:
            js = np.nonzero(w[v] > 0)[0]
            nnz.append(len(js))
            nanc.append(len(set().union(*[anc[j] for j in js])))
    E = len(world.extra_cols())
    hand = cfg["dof_per_hand"]
    P = cfg["body_pose_dof"] + 2 * hand
    return dict(M=int(fv.shape[0]), J=J, featN=9 * (J - 1),
                body_dof=cfg["body_pose_dof"], hand_pca=2 * hand if hand else 0,
                hand_aa=3 * J - cfg["body_pose_dof"] if hand else 0,
                hands=2 if hand else 0, E=E, D=3 + P + E,
                prior_dim=cfg["prior"]["dim"],
                prior_components=cfg["prior"]["components"],
                route=route,
                weights_per_vertex=nnz, ancestors_per_vertex=nanc)
