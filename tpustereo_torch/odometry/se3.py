"""SE(3) / SO(3) maps in torch for the odometry backend: hat maps,
exponential and logarithm maps, inverse. A copy of the JAX package's
`odometry/se3.py`, op for op. Small-angle branches are `torch.where` on
Taylor expansions, so every function is branch-free, takes any leading
batch shape, and runs under `torch.func.jacfwd` and `vmap`.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _safe_theta(w: torch.Tensor):
    """(…, 3) -> (t2, theta) with theta = ||w|| computed so the derivative
    at w = 0 is finite: forward-mode AD through `torch.linalg.norm` at 0
    gives NaN, exactly as in JAX, which would break `jacfwd` through exp/log
    at the identity, where the pose-graph GN linearises. theta is clamped
    below at _EPS; callers' small-angle branches use t2 directly."""
    t2 = torch.sum(w * w, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(torch.clamp(t2, min=_EPS * _EPS))
    return t2, theta


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(
        like.shape)


def _homogeneous(top: torch.Tensor) -> torch.Tensor:
    """(…, 3, 4) -> (…, 4, 4) with the row [0, 0, 0, 1] appended."""
    # the identity's last row: made on the device (a copy from the host
    # would synchronise)
    bottom = torch.eye(4, dtype=top.dtype, device=top.device)[3:].expand(
        top[..., :1, :].shape)
    return torch.cat([top, bottom], -2)


def hat(w: torch.Tensor) -> torch.Tensor:
    """(…, 3) -> (…, 3, 3) skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], -1),
        torch.stack([wz, z, -wx], -1),
        torch.stack([-wy, wx, z], -1),
    ], -2)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (…, 3) -> (…, 3, 3)."""
    t2, theta = _safe_theta(w)
    K = hat(w)
    K2 = K @ K
    # sin(t)/t and (1-cos t)/t^2 with Taylor fallbacks
    a = torch.where(theta > _EPS, torch.sin(theta) / torch.clamp(theta, min=_EPS),
                    1.0 - t2 / 6.0)
    b = torch.where(theta > _EPS,
                    (1.0 - torch.cos(theta)) / torch.clamp(t2, min=_EPS * _EPS),
                    0.5 - t2 / 24.0)
    return _eye3(K) + a * K + b * K2


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """(…, 3, 3) -> (…, 3)."""
    # (…, 1): a 0-dim trace would meet the python floats below as a
    # double under `torch.func.jacfwd` of a single pose
    tr = torch.diagonal(R, dim1=-2, dim2=-1).sum(-1, keepdim=True)
    cos = torch.clamp((tr - 1.0) / 2.0, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos)
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    s = torch.where(theta > _EPS,
                    theta / torch.clamp(2.0 * torch.sin(theta), min=_EPS),
                    0.5 + theta ** 2 / 12.0)
    return s * w


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """se(3) tangent (…, 6) [rho, w] -> (…, 4, 4) homogeneous transform."""
    rho, w = xi[..., :3], xi[..., 3:]
    R = exp_so3(w)
    t2, theta = _safe_theta(w)
    K = hat(w)
    K2 = K @ K
    b = torch.where(theta > _EPS,
                    (1.0 - torch.cos(theta)) / torch.clamp(t2, min=_EPS * _EPS),
                    0.5 - t2 / 24.0)
    c = torch.where(theta > _EPS,
                    (theta - torch.sin(theta))
                    / torch.clamp(t2 * theta, min=_EPS ** 3),
                    1.0 / 6.0 - t2 / 120.0)
    V = _eye3(K) + b * K + c * K2
    t = (V @ rho[..., None])[..., 0]
    return _homogeneous(torch.cat([R, t[..., None]], -1))


def log_se3(T: torch.Tensor) -> torch.Tensor:
    """(…, 4, 4) -> (…, 6) [rho, w]."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    w = log_so3(R)
    t2, theta = _safe_theta(w)
    K = hat(w)
    K2 = K @ K
    # V^{-1} = I - K/2 + (1/t^2 - (1+cos)/(2 t sin)) K^2
    cot_term = torch.where(
        theta > _EPS,
        1.0 / torch.clamp(t2, min=_EPS * _EPS)
        - (1.0 + torch.cos(theta))
        / torch.clamp(2.0 * theta * torch.sin(theta), min=_EPS * _EPS),
        1.0 / 12.0 + t2 / 720.0)
    Vinv = _eye3(K) - 0.5 * K + cot_term * K2
    rho = (Vinv @ t[..., None])[..., 0]
    return torch.cat([rho, w], -1)


def inv_se3(T: torch.Tensor) -> torch.Tensor:
    R, t = T[..., :3, :3], T[..., :3, 3]
    Rt = torch.swapaxes(R, -1, -2)
    ti = -(Rt @ t[..., None])[..., 0]
    return _homogeneous(torch.cat([Rt, ti[..., None]], -1))
