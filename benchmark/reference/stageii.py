"""The stage-ii forward model of one subject: packed per-frame parameters
x = (trans (3), pose (P), extras (E)) -> the subject's markers, and the
whole posed body.

The subject is its betas (the first `num_betas` shape coefficients) and its
latent markers; the extras are per-frame coefficients of their own
shapedirs columns (SMPL-X's expressions from column 300, or DMPLs after the
betas). The marker frames and coefficients are worked out here from the
canonical shaped body, as MoSh++ freezes them after stage i.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .body import Body
from .markers import frame_vertices, marker_coefficients, place_markers


class Subject:
    def __init__(self, body: Body, betas, latents, extra_cols: Sequence[int],
                 knn: int = 8):
        self.body = body
        dt, dev = body.dtype, body.v_template.device
        self.betas = torch.as_tensor(betas).to(dev, dt)
        nb = self.betas.shape[0]
        self.cols = list(range(nb)) + list(extra_cols)
        can = body.v_template + body.arith.einsum(
            "vcb,b->vc", body.shapedirs[..., :nb], self.betas)
        lat = torch.as_tensor(latents).to(dev, dt)
        self.frame = frame_vertices(can, lat, knn)             # (M, 3)
        self.coeffs = marker_coefficients(can, lat, self.frame)

    def _split(self, x: torch.Tensor):
        x = x.to(self.betas.dtype)
        E = len(self.cols) - self.betas.shape[0]
        P = x.shape[1] - 3 - E
        coeffs = torch.cat([self.betas.expand(x.shape[0], -1),
                            x[:, 3 + P:]], dim=1)
        return x[:, :3], x[:, 3:3 + P], coeffs

    def markers(self, x: torch.Tensor) -> torch.Tensor:
        """(N, M, 3) markers of packed parameters x (N, 3 + P + E)."""
        trans, pose, coeffs = self._split(x)
        vids = self.frame.reshape(-1)
        v = self.body.forward(pose, trans, coeffs, self.cols, vids)
        return place_markers(v.reshape(x.shape[0], -1, 3, 3), self.coeffs)

    def vertices(self, x: torch.Tensor) -> torch.Tensor:
        """(N, V, 3) the whole posed body of packed parameters x."""
        trans, pose, coeffs = self._split(x)
        return self.body.forward(pose, trans, coeffs, self.cols)
