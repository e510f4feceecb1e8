"""Axis-angle <-> rotation-matrix conversion, safe at theta -> 0.

Port of `moshpp_tpu/ops/rodrigues.py`: the same closed forms and the same
`_EPS` guards, on torch tensors with any leading batch shape.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12


def _quat(rotvec: torch.Tensor):
    """(w, x, y, z, s, theta) of the unit quaternion of `rotvec` (..., 3);
    s = sin(theta/2)/theta with theta = sqrt(|v|^2 + _EPS)."""
    theta = torch.sqrt(torch.sum(rotvec * rotvec, dim=-1) + _EPS)
    half = 0.5 * theta
    w = torch.cos(half)
    s = torch.sin(half) / theta
    return w, rotvec[..., 0] * s, rotvec[..., 1] * s, rotvec[..., 2] * s, s, theta


def _rot_from_quat(w, x, y, z) -> torch.Tensor:
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    rot = torch.stack(
        [
            1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
        ],
        dim=-1,
    )
    return rot.reshape(w.shape + (3, 3))


def rodrigues(rotvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle vectors (..., 3) -> rotation matrices (..., 3, 3).

    Quaternion formulation, differentiable through theta = 0."""
    w, x, y, z, _, _ = _quat(rotvec)
    return _rot_from_quat(w, x, y, z)


def rodrigues_with_grad(rotvec: torch.Tensor):
    """(R (..., 3, 3), dR (..., 3, 3, 3)) with dR[..., a, b, t] =
    dR_ab / dv_t.

    The hand derivative of the quaternion rule that the marker kernels use
    (`pallas_marker_jac._rodrigues_grad_rows`): dw/dv_t = -0.5 s v_t,
    dq_i/dv_t = delta_it s + v_i v_t (0.5 w - s) / theta^2.
    """
    w, x, y, z, s, theta = _quat(rotvec)
    R = _rot_from_quat(w, x, y, z)
    g = (0.5 * w - s) / (theta * theta)
    v = [rotvec[..., i] for i in range(3)]
    cols = []
    for t in range(3):
        dw = -0.5 * s * v[t]
        dx, dy, dz = [g * v[i] * v[t] + (s if i == t else 0.0) for i in range(3)]
        dxx, dyy, dzz = 2 * x * dx, 2 * y * dy, 2 * z * dz
        dxy = dx * y + x * dy
        dxz = dx * z + x * dz
        dyz = dy * z + y * dz
        dwx = dw * x + w * dx
        dwy = dw * y + w * dy
        dwz = dw * z + w * dz
        cols.append(torch.stack([
            -2.0 * (dyy + dzz), 2.0 * (dxy - dwz), 2.0 * (dxz + dwy),
            2.0 * (dxy + dwz), -2.0 * (dxx + dzz), 2.0 * (dyz - dwx),
            2.0 * (dxz - dwy), 2.0 * (dyz + dwx), -2.0 * (dxx + dyy)], dim=-1))
    dR = torch.stack(cols, dim=-1)                     # (..., 9, 3)
    return R, dR.reshape(w.shape + (3, 3, 3))


def rodrigues_inverse(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> axis-angle vectors (..., 3).

    Stable for angles in (0, pi); at exactly pi the axis sign is arbitrary.
    """
    trace = rot[..., 0, 0] + rot[..., 1, 1] + rot[..., 2, 2]
    cos_theta = torch.clamp(0.5 * (trace - 1.0), -1.0, 1.0)
    theta = torch.arccos(cos_theta)

    axis_sin = 0.5 * torch.stack(
        [
            rot[..., 2, 1] - rot[..., 1, 2],
            rot[..., 0, 2] - rot[..., 2, 0],
            rot[..., 1, 0] - rot[..., 0, 1],
        ],
        dim=-1,
    )
    sin_theta = torch.sin(theta)[..., None]
    small = torch.abs(sin_theta) < 1e-6
    one = torch.ones_like(sin_theta)
    scale = torch.where(small, one,
                        theta[..., None] / torch.where(small, one, sin_theta))
    rotvec_generic = axis_sin * scale

    diag = torch.stack([rot[..., 0, 0], rot[..., 1, 1], rot[..., 2, 2]], dim=-1)
    axis_abs = torch.sqrt(torch.clamp(
        (diag - cos_theta[..., None]) / (1.0 - cos_theta[..., None] + _EPS),
        min=0.0))
    axis_pi = axis_abs * torch.where(axis_sin >= 0, 1.0, -1.0)
    rotvec_pi = axis_pi * theta[..., None]

    near_pi = (math.pi - theta)[..., None] < 1e-4
    return torch.where(near_pi, rotvec_pi, rotvec_generic)


def axis_angle_to_quat(rotvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> unit quaternion (..., 4) as (w, xyz)."""
    theta = torch.sqrt(torch.sum(rotvec * rotvec, dim=-1, keepdim=True) + _EPS)
    half = 0.5 * theta
    return torch.cat([torch.cos(half), rotvec * (torch.sin(half) / theta)],
                     dim=-1)


def quat_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) (w, xyz) -> axis-angle (..., 3)."""
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    xyz = q[..., 1:]
    sin_half = torch.sqrt(torch.sum(xyz * xyz, dim=-1, keepdim=True) + _EPS)
    theta = 2.0 * torch.atan2(sin_half, w)
    return xyz * (theta / sin_half)


def slerp_axis_angle(a: torch.Tensor, b: torch.Tensor,
                     alpha: torch.Tensor) -> torch.Tensor:
    """Spherical interpolation between axis-angle rotations (..., 3);
    alpha broadcasts over the leading dims."""
    qa = axis_angle_to_quat(a)
    qb = axis_angle_to_quat(b)
    dot = torch.sum(qa * qb, dim=-1, keepdim=True)
    qb = qb * torch.where(dot < 0, -1.0, 1.0)          # shorter arc
    dot = torch.clamp(torch.abs(dot), -1.0, 1.0)
    omega = torch.arccos(torch.clamp(dot, 0.0, 1.0 - 1e-7))
    so = torch.sin(omega)
    small = so < 1e-4
    safe_so = torch.where(small, torch.ones_like(so), so)
    wa = torch.where(small, 1.0 - alpha, torch.sin((1.0 - alpha) * omega) / safe_so)
    wb = torch.where(small, alpha, torch.sin(alpha * omega) / safe_so)
    q = wa * qa + wb * qb
    q = q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + _EPS)
    return quat_to_axis_angle(q)
