"""The least time the card could take to form the dense Schur engine's
reduced camera system S = B_λ − Σ_j E_j C_j⁻¹ E_jᵀ, from a problem's
index arrays alone, whatever computes it.

Point j is seen through n_j columns of the camera tangent: 6 for each
distinct pose and ``ni`` for each distinct intrinsics block among its
valid observations (9·k_j for a BAL point seen by k_j cameras).  Only
those columns of its E_j are nonzero, so its share needs 18·n_j
operations for C_j⁻¹E_jᵀ (a 3×3 by 3×n_j product, an FMA counting 2)
and 3·n_j·(n_j + 1) for the symmetric half of E_j (C_j⁻¹E_jᵀ): its
n_j(n_j + 1)/2 entries, each a dot product of length 3.  Bytes: E's
nonzero blocks (3·n_j a
point) and C (9 a point) read once, S (Dc²) written once.  Peaks are
``roofline.py``'s: 3.35 TB/s, 67 TFLOP/s in float32.
"""
from __future__ import annotations

import numpy as np

from .roofline import PEAK_BYTES_S, PEAK_FLOPS


def _distinct_per_point(point: np.ndarray, key: np.ndarray,
                        n_points: int) -> np.ndarray:
    """How many distinct ``key`` values each point has (n_points,)."""
    pairs = np.unique(point.astype(np.int64) * (int(key.max()) + 1) + key)
    return np.bincount(pairs // (int(key.max()) + 1), minlength=n_points)


def reduced_bound(point, pose, intr_idx, mask, n_points: int, n_poses: int,
                  n_intr: int, ni: int, itemsize: int) -> dict:
    """Operations, bytes and the bound (seconds) of one reduced system,
    from the observations' index arrays (padding rows have mask 0)."""
    m = np.asarray(mask) > 0
    pt = np.asarray(point)[m]
    n = 6 * _distinct_per_point(pt, np.asarray(pose)[m].astype(np.int64),
                                n_points)
    if ni > 0:
        n = n + ni * _distinct_per_point(
            pt, np.asarray(intr_idx)[m].astype(np.int64), n_points)
    n = n.astype(np.int64)
    flops = int(np.sum(18 * n + 3 * n * (n + 1)))
    dc = 6 * n_poses + ni * n_intr
    nbytes = itemsize * int(np.sum(3 * n) + 9 * n_points + dc * dc)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS
    return {"flops": flops, "bytes": nbytes,
            "bound_s": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
