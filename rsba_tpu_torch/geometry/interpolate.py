"""Pose interpolation across rolling-shutter scanlines.

Counterpart of ``rsba_tpu/geometry/interpolate.py``.  Rotation modes:
``"slerp"`` (geodesic), ``"nlerp"`` (normalized linear, the "linear"
mode of config 3) and ``"lerp_aa"`` (lerp of global angle-axis vectors).
The camera center is always interpolated linearly; ``t ∈ [0, 1]`` is the
row-normalized shutter time.
"""
from __future__ import annotations

import torch

from . import quaternion as quat

ROTATION_INTERP_MODES = ("slerp", "nlerp", "lerp_aa")


def interpolate_rotation(qa: torch.Tensor, qb: torch.Tensor, t,
                         mode: str) -> torch.Tensor:
    """Interpolate rotation between two unit quaternions."""
    if mode == "slerp":
        return quat.slerp(qa, qb, t)
    if mode == "nlerp":
        return quat.nlerp(qa, qb, t)
    if mode == "lerp_aa":
        return quat.lerp_axis_angle(quat.to_axis_angle(qa),
                                    quat.to_axis_angle(qb), t)
    raise ValueError(f"unknown rotation interpolation mode: {mode!r}")


def interpolate_pose(qa: torch.Tensor, ca: torch.Tensor, qb: torch.Tensor,
                     cb: torch.Tensor, t, mode: str
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(q(t), c(t)) between keyframe poses (qa, ca) and (qb, cb)."""
    q = interpolate_rotation(qa, qb, t, mode)
    tt = quat._t(t, ca)
    c = (1.0 - tt) * ca + tt * cb
    return q, c
