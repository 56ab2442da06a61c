"""Multi-view point triangulation (global shutter and the interpolated-pose
rolling-shutter variant).

Counterpart of ``rsba_tpu/geometry/triangulate.py``: the midpoint (ray
least-squares) method.  The normal matrix ``A = Σ (I − d dᵀ)`` accumulates
as batched 3×3 outer products over a padded view axis (no per-point SVD,
no data-dependent shapes) and the solve is a closed-form symmetric 3×3
inverse, the same structure as the Schur point blocks.

Rolling shutter: each observation's ray uses the pose interpolated at its
measured row time t, so the variant is the same code path with per-view
(q, c).

All functions are batched over arbitrary leading dims, masked (padded
views carry mask 0), and safe on degenerate input (``valid=False``, never
NaN).
"""
from __future__ import annotations

import torch

from . import camera
from . import distortion as dist
from . import interpolate
from . import quaternion as quat
from .camera import CameraModel


def backproject(uv: torch.Tensor, intr: torch.Tensor,
                model: CameraModel) -> torch.Tensor:
    """Pixel → unit ray direction in the camera frame.

    Inverts ``camera.project_camera_point``: pixel → normalized plane
    (intrinsics), undistort (iterative), then the ray ``[x, y, s]`` with
    ``s = projection_sign``, so that a point at positive depth projects
    back onto ``uv``.
    """
    xy = (uv - intr[..., 2:4]) / intr[..., 0:2]
    if model.use_distortion:
        xy = dist.undistort(xy, intr[..., 4:9])
    d = torch.cat([xy, torch.full_like(xy[..., :1], model.projection_sign)],
                  dim=-1)
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def triangulate_rays(origins: torch.Tensor, dirs: torch.Tensor,
                     mask: torch.Tensor, cond_tol: float = 1e-6):
    """Midpoint triangulation of masked ray bundles.

    Minimizes Σᵢ mᵢ‖(I − dᵢdᵢᵀ)(X − oᵢ)‖² in closed form:
    ``A X = b`` with ``A = Σ m (I − ddᵀ)``, ``b = Σ m (I − ddᵀ) o``.

    Args:
      origins: (..., L, 3) ray origins (camera centers).
      dirs:    (..., L, 3) unit ray directions (world frame).
      mask:    (..., L) 1.0 valid view / 0.0 padding.
      cond_tol: a bundle is valid when ``det(A) > cond_tol · (tr(A)/3)³``
        (near-parallel rays make A rank-deficient; det/tr³ is a scale-free
        proxy for 1/condition).

    Returns:
      X: (..., 3) triangulated points (zeros where invalid).
      valid: (...,) bool — at least 2 views and well conditioned.
    """
    m = mask[..., None, None]
    eye = torch.eye(3, dtype=dirs.dtype, device=dirs.device)
    Pm = m * (eye - dirs[..., :, None] * dirs[..., None, :])  # (..., L, 3, 3)
    A = torch.sum(Pm, dim=-3)                                 # (..., 3, 3)
    b = torch.sum(Pm @ origins[..., :, None], dim=-3)[..., 0]

    # Closed-form symmetric 3×3 inverse with a determinant gate.
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    co00 = a11 * a22 - a12 * a12
    co01 = a02 * a12 - a01 * a22
    co02 = a01 * a12 - a02 * a11
    det = a00 * co00 + a01 * co01 + a02 * co02
    tr3 = (a00 + a11 + a22) / 3.0
    n_views = torch.sum(mask, dim=-1)
    valid = (n_views >= 2) & (det > cond_tol * torch.clamp(tr3, min=0.0) ** 3)

    safe_det = torch.where(valid, det, 1.0)
    co11 = a00 * a22 - a02 * a02
    co12 = a02 * a01 - a00 * a12
    co22 = a00 * a11 - a01 * a01
    Ainv = torch.stack([
        torch.stack([co00, co01, co02], dim=-1),
        torch.stack([co01, co11, co12], dim=-1),
        torch.stack([co02, co12, co22], dim=-1)], dim=-2) / \
        safe_det[..., None, None]
    X = (Ainv @ b[..., :, None])[..., 0]
    return torch.where(valid[..., None], X, 0.0), valid


def triangulate(qa, ca, qb, cb, intr, uv, t, mask, model: CameraModel,
                cond_tol: float = 1e-6, min_depth: float = 0.0):
    """Triangulate points from per-view observations (GS or RS).

    Args (per point, batched over leading dims; L = view axis):
      qa, ca, qb, cb: (..., L, 4/3) keyframe pose pairs per view (GS uses
        qa/ca only).
      intr: (..., L, 9) intrinsics per view (broadcastable).
      uv:   (..., L, 2) measured pixels.
      t:    (..., L) shutter times (rows/H; ignored for GS).
      mask: (..., L) view validity.
      min_depth: cheirality gate — a view whose triangulated point lands at
        depth ≤ min_depth along its ray invalidates the bundle.

    Returns (X, valid) as :func:`triangulate_rays`, with ``valid`` also
    requiring cheirality in every contributing view.
    """
    if model.rolling_shutter:
        q, c = interpolate.interpolate_pose(qa, ca, qb, cb, t,
                                            model.rotation_interp)
    else:
        q, c = qa, ca
    d_world = quat.rotate_inverse(q, backproject(uv, intr, model))
    X, valid = triangulate_rays(c, d_world, mask, cond_tol)

    # Cheirality: the depth along each contributing ray must be positive.
    depth = torch.sum((X[..., None, :] - c) * d_world, dim=-1)   # (..., L)
    front = (depth > min_depth) | ~(mask > 0)
    return X, valid & torch.all(front, dim=-1)


def reprojection_error(qa, ca, qb, cb, intr, uv, t, mask,
                       model: CameraModel, X: torch.Tensor) -> torch.Tensor:
    """Max masked reprojection error (px) of candidate points X: the
    acceptance gate the pipeline applies after triangulation."""
    proj = camera.project(qa, ca, qb, cb, intr, X[..., None, :], t, model)
    err = torch.linalg.vector_norm(proj - uv, dim=-1)
    return torch.max(torch.where(mask > 0, err, 0.0), dim=-1).values
