"""Robust frame registration: P3P + RANSAC in one batched pass.

Counterpart of ``rsba_tpu/solver/ransac.py``: registration of a new frame
from raw 2D-3D matches with outliers and no prior pose.  All hypotheses
run at once: K sampled triples → batched Grunert P3P (``solver/p3p.py``,
≤ 4K candidate poses) → one batched projection of every candidate against
every match (a (4K, M) scoring pass) → argmax of the inlier counts, then
one robust pose-only LM polish on the winner's inliers
(``solver/pnp.py``).

Rolling shutter: hypotheses are scored under the global-shutter model
(the warp within a frame is a few pixels, absorbed by the inlier
threshold); the final polish runs the full model when ``rows`` and
``image_height`` are given.

The triples are drawn with ``np.random.RandomState(seed)`` as the
reference draws them, so both packages score the same hypotheses.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import default_device
from ..geometry import CameraModel, Loss, camera, triangulate
from . import p3p as p3p_mod
from . import pnp
from .options import SolverOptions


def ransac_pnp(
    points3d,
    uv,
    intr,
    model: CameraModel,
    *,
    rows=None,
    image_height: Optional[int] = None,
    n_hypotheses: int = 256,
    inlier_threshold: float = 8.0,
    min_inliers: int = 6,
    seed: int = 0,
    refine: bool = True,
    loss: Loss = Loss("huber", 4.0),
    options: Optional[SolverOptions] = None,
    dtype=None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           np.ndarray, dict]:
    """Register a frame from 2D-3D matches: no prior pose, outliers allowed.

    Args (host arrays):
      points3d: (M, 3) map points.
      uv: (M, 2) measured pixels.
      intr: (9,) intrinsics.
      model: camera model (scoring always GS; RS used for the polish).
      rows / image_height: RS shutter rows (required for an RS polish).
      n_hypotheses: sampled minimal triples (all solved in one pass).
      inlier_threshold: reprojection gate in pixels.
      min_inliers: fail below this support.
      refine: run the robust pose-only LM polish on the inliers.
      dtype: working dtype (default: that of ``points3d``).
      device: None is the card (RuntimeError without one), "cpu" the CPU.

    Returns (q_a, c_a, q_b, c_b, inlier_mask, info); info carries
    ``num_inliers``, ``num_hypotheses``, ``best_inliers_prepolish`` and
    the polish Summary (or None).  Raises ValueError when no hypothesis
    reaches ``min_inliers``.
    """
    points3d = np.asarray(points3d)
    uv_np = np.asarray(uv)
    M = points3d.shape[0]
    if M < 3:
        raise ValueError(f"need >= 3 matches, got {M}")
    device = default_device(device)
    if dtype is None:
        dtype = (torch.float32 if points3d.dtype == np.float32
                 else torch.float64)

    rng = np.random.RandomState(seed)
    idx = rng.randint(0, M, size=(n_hypotheses, 3))
    # Duplicate indices inside a triple (degenerate P3P) are resampled
    # once; what duplicates remain give invalid hypotheses, which the
    # valid mask discards.
    dup = ((idx[:, 0] == idx[:, 1]) | (idx[:, 0] == idx[:, 2])
           | (idx[:, 1] == idx[:, 2]))
    idx[dup] = rng.randint(0, M, size=(int(dup.sum()), 3))

    gs = CameraModel(rolling_shutter=False,
                     use_distortion=model.use_distortion,
                     projection_sign=model.projection_sign)
    as_t = lambda a: torch.as_tensor(  # noqa: E731
        np.asarray(a), device=device).to(dtype)
    intr_t, pts_t, uv_t = as_t(intr), as_t(points3d), as_t(uv_np)
    idx_t = torch.as_tensor(idx, device=device)

    rays = triangulate.backproject(uv_t[idx_t], intr_t, gs)
    q_cand, c_cand, valid = p3p_mod.p3p(rays, pts_t[idx_t])
    q_flat = q_cand.reshape(-1, 4)                     # (4K, 4)
    c_flat = c_cand.reshape(-1, 3)
    v_flat = valid.reshape(-1)

    # Score every candidate against every match (GS projection).
    qk, ck = q_flat[:, None, :], c_flat[:, None, :]
    proj = camera.project_global(qk, ck, intr_t, pts_t[None, :, :], gs)
    err2 = torch.sum((proj - uv_t[None, :, :]) ** 2, dim=-1)   # (4K, M)
    depth = camera.depth_in_camera(qk, ck, qk, ck, pts_t[None, :, :],
                                   torch.zeros_like(err2), gs)
    inl = (err2 <= inlier_threshold ** 2) & (depth > 0)
    counts = torch.where(v_flat, torch.sum(inl, dim=-1), -1)
    best = torch.argmax(counts)                 # first maximum on a tie
    # The winner's count, pose and inlier mask come back in one transfer.
    packed = torch.cat([counts[best].to(dtype)[None], q_flat[best],
                        c_flat[best], inl[best].to(dtype)]).tolist()
    n_best = int(packed[0])
    if n_best < min_inliers:
        raise ValueError(
            f"RANSAC failed: best hypothesis has {max(n_best, 0)} inliers "
            f"(< {min_inliers}) over {n_hypotheses} samples")
    q_best, c_best = q_flat[best], c_flat[best]
    inlier_mask = np.asarray(packed[8:]) > 0

    info = {"num_hypotheses": n_hypotheses,
            "best_inliers_prepolish": n_best, "summary": None}
    if not refine:
        info["num_inliers"] = n_best
        return q_best, c_best, q_best, c_best, inlier_mask, info

    sel = np.nonzero(inlier_mask)[0]
    rows_sel = (np.asarray(rows)[sel] if rows is not None
                else np.zeros(sel.shape[0]))
    q_a, c_a, q_b, c_b, summary = pnp.register_frame(
        points3d[sel], uv_np[sel], rows_sel, np.asarray(intr), model,
        np.asarray(packed[1:5]), np.asarray(packed[5:8]),
        image_height=image_height, loss=loss, options=options,
        dtype=dtype, device=device)
    # Final inlier set under the polished pose.
    if model.rolling_shutter and rows is not None:
        t_all = as_t(np.clip(np.asarray(rows), 0, image_height)
                     / float(image_height))
    else:
        t_all = torch.zeros(M, dtype=dtype, device=device)
    proj2 = camera.project(q_a, c_a, q_b, c_b, intr_t, pts_t, t_all, model)
    err2f = torch.sum((proj2 - uv_t) ** 2, dim=-1)
    # The gate of the hypothesis scoring: reprojection and cheirality.  A
    # point behind the camera whose (distorted) projection lands near uv
    # must not count as an inlier.
    depth_f = camera.depth_in_camera(q_a, c_a, q_b, c_b, pts_t, t_all,
                                     model)
    inlier_mask = ((err2f <= inlier_threshold ** 2)
                   & (depth_f > 0)).cpu().numpy()
    info["num_inliers"] = int(inlier_mask.sum())
    info["summary"] = summary
    return q_a, c_a, q_b, c_b, inlier_mask, info
