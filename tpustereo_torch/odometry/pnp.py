"""3D→2D pose refinement: Gauss–Newton on SE(3) with Huber IRLS weights
(SURVEY.md §4.4 `odometry.pnp_gn`). A copy of the JAX package's
`odometry/pnp.py`: a fixed iteration count, float32, on the device of the
inputs, and no host synchronisation (the 6x6 solve does not check for a
singular matrix, as `jnp.linalg.solve` does not).

Estimates T (previous-keyframe camera → current camera) minimising
Σ w‖π(T·X_i) − u_i‖² over matched (X_i, u_i); invalid matches carry w=0.
"""

from __future__ import annotations

import torch

from tpustereo_torch.odometry.se3 import exp_se3


def project(P: torch.Tensor, fx, fy, cx, cy) -> torch.Tensor:
    """(N, 3) camera points -> (N, 2) pixels."""
    z = torch.clamp(P[:, 2], min=1e-6)
    return torch.stack([fx * P[:, 0] / z + cx, fy * P[:, 1] / z + cy], -1)


def _solve(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """H^-1 g without the error check of `torch.linalg.solve`, which reads
    the factorisation's status on the host."""
    return torch.linalg.solve_ex(H, g, check_errors=False)[0]


def gauss_newton_pose(X: torch.Tensor, u: torch.Tensor, w: torch.Tensor,
                      intrinsics: torch.Tensor, T0: torch.Tensor | None = None,
                      iters: int = 10, huber: float = 3.0):
    """X (N,3) 3D pts in keyframe cam frame; u (N,2) pixels in current frame;
    w (N,) weights (0 = invalid); intrinsics [fx, fy, cx, cy].
    Returns (T (4,4), mean_weighted_residual)."""
    fx, fy, cx, cy = intrinsics
    T = (torch.eye(4, dtype=torch.float32, device=X.device) if T0 is None
         else T0)
    eye6 = 1e-6 * torch.eye(6, dtype=torch.float32, device=X.device)
    for _ in range(iters):
        R, t = T[:3, :3], T[:3, 3]
        P = X @ R.T + t                          # (N, 3) current-cam points
        z = torch.clamp(P[:, 2], min=1e-6)
        pred = torch.stack([fx * P[:, 0] / z + cx, fy * P[:, 1] / z + cy], -1)
        r = pred - u                              # (N, 2)
        # Huber IRLS weight on the residual norm
        rn = torch.linalg.norm(r, dim=-1)
        wh = torch.where(rn > huber, huber / torch.clamp(rn, min=1e-9),
                         1.0) * w
        # Jacobian of reprojection wrt left-multiplied twist [rho, omega]
        x, y = P[:, 0], P[:, 1]
        zi = 1.0 / z
        zero = torch.zeros_like(z)
        # d(pred)/dP
        JP_u = torch.stack([fx * zi, zero, -fx * x * zi * zi], -1)  # (N, 3)
        JP_v = torch.stack([zero, fy * zi, -fy * y * zi * zi], -1)

        def row(JP):
            # dP/dxi: [I | -hat(P)]
            Jw = torch.stack([
                JP[:, 1] * P[:, 2] - JP[:, 2] * P[:, 1],
                JP[:, 2] * P[:, 0] - JP[:, 0] * P[:, 2],
                JP[:, 0] * P[:, 1] - JP[:, 1] * P[:, 0],
            ], -1) * -1.0
            return torch.cat([JP, Jw], -1)                      # (N, 6)
        J = torch.stack([row(JP_u), row(JP_v)], 1)              # (N, 2, 6)
        Jw = J * wh[:, None, None]
        H = torch.einsum("nki,nkj->ij", Jw, J) + eye6
        g = torch.einsum("nki,nk->i", Jw, r)
        T = exp_se3(-_solve(H, g)) @ T
    # final residual for keyframe decisions / diagnostics
    R, t = T[:3, :3], T[:3, 3]
    pred = project(X @ R.T + t, fx, fy, cx, cy)
    rn = torch.linalg.norm(pred - u, dim=-1)
    wsum = torch.clamp(w.sum(), min=1e-6)
    return T, (rn * w).sum() / wsum
