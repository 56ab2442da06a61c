"""Radial-tangential (Brown–Conrady) lens distortion.

Counterpart of ``rsba_tpu/geometry/distortion.py``.
Coefficients are packed ``[k1, k2, p1, p2, k3]`` (OpenCV order):

    r² = x² + y²
    radial = 1 + k1·r² + k2·r⁴ + k3·r⁶
    x' = x·radial + 2·p1·x·y + p2·(r² + 2x²)
    y' = y·radial + p1·(r² + 2y²) + 2·p2·x·y
"""
from __future__ import annotations

import torch


def distort(xy: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """Distort normalized image points (…, 2) with coefficients (…, 5).

    Components keep a trailing unit axis: under ``torch.func.jacfwd`` a
    0-d tensor plus a Python float yields a float64 tangent.
    """
    x, y = xy[..., 0:1], xy[..., 1:2]
    k1, k2, p1, p2, k3 = (coeffs[..., i:i + 1] for i in range(5))
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.cat([xd, yd], dim=-1)


def undistort(xy_d: torch.Tensor, coeffs: torch.Tensor,
              iters: int = 8) -> torch.Tensor:
    """Invert :func:`distort` by ``iters`` fixed-point steps (OpenCV
    style).  For initialisation paths (rays from distorted detections),
    never inside the optimiser's loop."""
    xd, yd = xy_d[..., 0:1], xy_d[..., 1:2]
    k1, k2, p1, p2, k3 = (coeffs[..., i:i + 1] for i in range(5))
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x, y = (xd - dx) / radial, (yd - dy) / radial
    return torch.cat([x, y], dim=-1)
