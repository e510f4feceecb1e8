"""What decides `correct`, and the fit metrics, from what the timed solves
returned.

For every frame of every solve in the window, the reference's forward model
is run at the solved parameters (trans, pose, extras):

- `sim_gap_mm`: the widest distance between a marker the program returned
  (`markers_sim`) and the reference's marker at the same parameters;
- `pose_gap_mrad`: the widest difference between the program's expanded
  axis-angles (`fullpose`, the hand PCA expanded) and the reference's;
- `fit_mm`: the worst solve's mean distance between the observed markers
  and the reference's markers at the solved parameters;
- `marker_fit_mm`: the same distance of the worst marker, its mean over a
  solve's frames, the largest over the markers and solves.

The first two hold the program's outputs to the reference's arithmetic;
the third holds the solve itself (the system, the dogleg loop, its
kernels and the phase schedule) to a fit that a sound solve reaches.
The end-to-end `marker_err_mm` is the mean of the same distances over all
frames, and `v2v_body_mm` the mean body-vertex distance between the solved
and the true bodies, both through the reference, on 64 frames a solve.

`control` replaces the program's `markers_sim` and `fullpose` with the
reference's own in TF32 (the next precision below the configuration's
float32 with TF32 off): the comparison must fail it.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from reference import Body, Subject

V2V_FRAMES = 64
BLOCK = 4096


def _x(out: dict) -> torch.Tensor:
    return torch.cat([out["trans"], out["pose"], out["extra"]], dim=1)


class Judge:
    def __init__(self, world):
        self.world = world
        self.ref: Subject = world.reference
        self.body: Body = world.reference.body
        self.body_v = self.body.body_vertices()

    def _control_subject(self) -> Subject:
        w = self.world
        body = Body.from_files(w.model_arrays, w.hand_arrays,
                               body_pose_dof=w.cfg["body_pose_dof"],
                               dof_per_hand=w.cfg["dof_per_hand"],
                               use_hands_mean=w.cfg["use_hands_mean"],
                               device=w.device, precision="tf32")
        return Subject(body, w.betas, w.latents, w.extra_cols())

    def control_outputs(self, outs: List[dict]) -> List[dict]:
        """The outputs with `markers_sim` and `fullpose` from the
        reference in TF32 at the program's parameters."""
        sub = self._control_subject()
        res = []
        for o in outs:
            x = _x(o).to(self.world.device)
            sim = torch.cat([sub.markers(x[s:s + BLOCK])
                             for s in range(0, x.shape[0], BLOCK)])
            fp = sub.body.fullpose(x[:, 3:3 + o["pose"].shape[1]])
            res.append(dict(o, markers_sim=sim.float().cpu(),
                            fullpose=fp.float().cpu()))
        return res

    def assess(self, outs: List[dict], pool_ids: List[int]) -> dict:
        """Readings over the window's solves `outs` of captures
        `pool_ids`."""
        w, dev = self.world, self.world.device
        sim_gap = pose_gap = 0.0
        fits, errs, v2v, worst_marker = [], [], [], []
        finite = True
        F = w.frames
        sub_idx = torch.linspace(0, F - 1, V2V_FRAMES, device=dev).long()
        for o, pid in zip(outs, pool_ids):
            x = _x(o).to(dev)
            finite &= bool(torch.isfinite(x).all())
            obs = w.obs[pid].to(torch.float64)
            mask = w.mask
            err_sum = 0.0
            per_marker = 0.0
            for s in range(0, F, BLOCK):
                m = self.ref.markers(x[s:s + BLOCK])
                got = o["markers_sim"][s:s + BLOCK].to(dev, torch.float64)
                sim_gap = max(sim_gap, float(
                    torch.linalg.vector_norm(got - m, dim=-1).max()))
                d = torch.linalg.vector_norm(m - obs[s:s + BLOCK], dim=-1)
                mk = mask[s:s + BLOCK].to(torch.float64)
                err_sum += float(((d * mk).sum(1) / mk.sum(1).clamp(min=1))
                                 .sum())
                per_marker = per_marker + (d * mk).sum(0)
            P = o["pose"].shape[1]
            fp = self.body.fullpose(x[:, 3:3 + P])
            pose_gap = max(pose_gap, float(
                (o["fullpose"].to(dev, torch.float64) - fp).abs().max()))
            fits.append(err_sum / F)
            seen = mask.to(torch.float64).sum(0).clamp(min=1)
            worst_marker.append(float((per_marker / seen).max()))
            errs.append(err_sum)
            vs = self.ref.vertices(x[sub_idx])[:, self.body_v]
            vt = self.ref.vertices(w.x_true[pid][sub_idx])[:, self.body_v]
            v2v.append(float(torch.linalg.vector_norm(vs - vt, dim=-1)
                             .mean()))
        frames = F * len(outs)
        big = float("inf")
        return {
            "sim_gap_mm": sim_gap * 1e3 if finite else big,
            "pose_gap_mrad": pose_gap * 1e3 if finite else big,
            "fit_mm": max(fits) * 1e3 if finite else big,
            "marker_fit_mm": max(worst_marker) * 1e3 if finite else big,
            "per_solve_marker_fit_mm": [f * 1e3 for f in worst_marker],
            "per_solve_fit_mm": [f * 1e3 for f in fits],
            "marker_err_mm": sum(errs) / frames * 1e3 if finite else big,
            "v2v_body_mm": float(np.mean(v2v)) * 1e3 if finite else big,
        }


CHECKED = ("sim_gap_mm", "pose_gap_mrad", "fit_mm", "marker_fit_mm")


def checks(readings: dict, limits: Dict[str, float]) -> dict:
    """{name: {"value", "limit"}} of each compared number."""
    return {k: {"value": readings[k], "limit": float(limits[k])}
            for k in CHECKED}


def passed(chk: dict) -> bool:
    return all(v["value"] <= v["limit"] for v in chk.values())


def failed_solves(readings: dict, limits: Dict[str, float]) -> int:
    """Solves whose own fit is over the limit (all of them when an output
    is off the reference or not finite)."""
    fits = readings["per_solve_fit_mm"]
    if (readings["sim_gap_mm"] > limits["sim_gap_mm"]
            or readings["pose_gap_mrad"] > limits["pose_gap_mrad"]):
        return len(fits)
    return sum(1 for f, m in zip(fits, readings["per_solve_marker_fit_mm"])
               if not (f <= limits["fit_mm"] and m <= limits["marker_fit_mm"]))
