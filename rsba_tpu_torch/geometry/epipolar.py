"""Two-view relative pose: 8-point essential matrix and the cheirality
bootstrap.

Counterpart of ``rsba_tpu/geometry/epipolar.py``.  The 8-point system is
solved as the smallest eigenvector of the 9×9 normal matrix ``AᵀA``
(symmetric ``eigh``) rather than an (N, 9) SVD; rays, not image points,
feed the constraint, so any camera convention or distortion is absorbed
by ``triangulate.backproject``.

Convention: for world-frame cameras ``X_cam = R(q)(X − c)`` with camera 1
at identity, ``d₂ᵀ E d₁ = 0`` with ``E = [t]× R``, ``R = R₂``,
``t = −R₂ c₂``, so ``c₂ = −Rᵀ t`` with the scale gauge ``‖t‖ = 1``.

``eigh`` and ``svd`` fix their vectors only up to sign, so E and the raw
factors may differ in sign between libraries; what comes out of the
cheirality vote in ``two_view_init`` does not.
"""
from __future__ import annotations

import numpy as np
import torch

from . import quaternion as quat
from . import triangulate
from .camera import CameraModel


def _proper(U: torch.Tensor) -> torch.Tensor:
    """Flip a batch of orthogonal matrices to determinant +1."""
    return U * torch.sign(torch.linalg.det(U))[..., None, None]


def essential_from_rays(d1: torch.Tensor, d2: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """Least-squares essential matrix from ≥ 8 masked ray correspondences.

    Rows of the design matrix are outer(d2, d1).reshape(9); the minimizer
    of ‖A e‖ with ‖e‖ = 1 is the smallest eigenvector of AᵀA.  The result
    is projected onto the essential manifold (singular values (1, 1, 0)).
    """
    rows = (d2[..., :, None] * d1[..., None, :]).reshape(
        d1.shape[:-1] + (9,))
    rows = rows * mask[..., None]
    AtA = rows.transpose(-1, -2) @ rows
    _, vecs = torch.linalg.eigh(AtA)          # ascending eigenvalues
    E = vecs[..., :, 0].reshape(AtA.shape[:-2] + (3, 3))
    U, _, Vt = torch.linalg.svd(E)
    # U and Vt proper rotations, so that the decomposition is direct.
    s = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return _proper(U) @ (s[:, None] * _proper(Vt))


def decompose_essential(E: torch.Tensor):
    """E → the four (R, t) candidates: (Ra, ±t), (Rb, ±t), ‖t‖ = 1."""
    U, _, Vt = torch.linalg.svd(E)
    U, Vt = _proper(U), _proper(Vt)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    return U @ W @ Vt, U @ W.T @ Vt, U[..., :, 2]


def two_view_init(uv1, uv2, intr, mask, model: CameraModel, *,
                  device=None, dtype=torch.float64):
    """Bootstrap a camera pair from pixel correspondences.

    Camera 1 is the identity pose; the distortion and sign conventions of
    ``model`` are honoured through backprojection, but both frames are
    treated as global shutter (the bootstrap pair is refined by the first
    windowed rolling-shutter BA).

    Tensors are used where they lie.  Numpy inputs are placed on
    ``device`` in ``dtype``: ``device=None`` is the card (RuntimeError
    without one), ``device="cpu"`` the CPU.

    Returns (q2, c2, X, point_valid, quality): camera 2's pose (wxyz,
    world center, ‖baseline‖ = 1 gauge), midpoint-triangulated points for
    every correspondence, their validity (cheirality in both views and
    ray conditioning), and the fraction of masked correspondences that
    triangulated validly under the winning candidate.
    """
    if not isinstance(uv1, torch.Tensor):
        from .. import default_device
        dev = default_device(device)
        uv1, uv2, intr, mask = (
            torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
            for a in (uv1, uv2, intr, mask))
    d1 = triangulate.backproject(uv1, intr, model)
    d2 = triangulate.backproject(uv2, intr, model)
    Ra, Rb, t = decompose_essential(essential_from_rays(d1, d2, mask))

    # The four candidates as one batch.
    R = torch.stack([Ra, Ra, Rb, Rb])                          # (4, 3, 3)
    tv = torch.stack([t, -t, t, -t])                           # (4, 3)
    q2 = quat.from_matrix(R)                                   # (4, 4)
    c2 = -quat.rotate_inverse(q2, tv)                          # (4, 3)
    d2w = quat.rotate_inverse(q2[:, None, :], d2[None])        # (4, n, 3)
    dirs = torch.stack([d1[None].expand_as(d2w), d2w], dim=-2)  # (4, n, 2, 3)
    org = torch.stack([torch.zeros_like(c2), c2], dim=-2)      # (4, 2, 3)
    org = org[:, None].expand_as(dirs)
    X, valid = triangulate.triangulate_rays(
        org, dirs, torch.ones(dirs.shape[:-1], dtype=dirs.dtype,
                              device=dirs.device))
    depth1 = torch.sum(X * d1[None], dim=-1)
    depth2 = torch.sum((X - c2[:, None, :]) * d2w, dim=-1)
    good = valid & (depth1 > 0) & (depth2 > 0) & (mask > 0)[None]
    counts = torch.sum(good, dim=-1)
    best = torch.argmax(counts)            # first maximum on a tie
    quality = counts[best] / torch.clamp(torch.sum(mask), min=1.0)
    return q2[best], c2[best], X[best], good[best], quality
