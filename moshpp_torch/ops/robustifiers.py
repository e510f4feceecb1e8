"""Robustifiers on signed squared quantities (port of
`moshpp_tpu/ops/robustifiers.py`; reference `scan2mesh/robustifiers.py`).
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def signed_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt(|x|) * sign(x), with a zero (not NaN) derivative at x = 0."""
    return torch.sign(x) * torch.sqrt(torch.abs(x) + _EPS)


def gmof(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Geman-McClure on a signed squared distance:
    signed_sqrt(s^2 x^2 / (s^2 + x^2) sign(x))."""
    sq = x * x
    inner = (sigma * sigma) * sq / (sigma * sigma + sq) * torch.sign(x)
    return signed_sqrt(inner)


def gmof_normalized(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Normalized Geman-McClure, output in [-1, 1]."""
    sq = x * x
    inner = sq / (sigma * sigma + sq) * torch.sign(x)
    return signed_sqrt(inner)
