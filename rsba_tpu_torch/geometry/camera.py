"""Camera models: world → image projection for global and rolling shutter.

Counterpart of ``rsba_tpu/geometry/camera.py``, same conventions:

* Pose (q, c): ``X_cam = R(q) · (X_world − c)``.
* ``xy = s · X_cam.xy / X_cam.z`` with ``s = projection_sign``.
* Intrinsics 9-vector ``[fx, fy, cx, cy, k1, k2, p1, p2, k3]``;
  ``u = fx·x' + cx``, ``v = fy·y' + cy``.
* Rolling shutter: the pose at row time t interpolates the observation's
  two keyframe poses (geometry.interpolate).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import distortion as dist
from . import interpolate
from . import quaternion as quat


@dataclasses.dataclass(frozen=True)
class CameraModel:
    """Static configuration of the projection chain.

    rolling_shutter: if False, pose_a is used as is (global shutter).
    rotation_interp: "slerp", "nlerp" or "lerp_aa" (rolling shutter only).
    use_distortion: apply radial-tangential distortion.
    projection_sign: +1.0 standard CV; −1.0 for BAL-convention cameras.
    """
    rolling_shutter: bool = False
    rotation_interp: str = "slerp"
    use_distortion: bool = True
    projection_sign: float = 1.0

    def __post_init__(self):
        if self.rotation_interp not in interpolate.ROTATION_INTERP_MODES:
            raise ValueError(
                f"rotation_interp must be one of "
                f"{interpolate.ROTATION_INTERP_MODES}, got "
                f"{self.rotation_interp!r}")


def intrinsics_vector(fx, fy=None, cx=0.0, cy=0.0, k1=0.0, k2=0.0, p1=0.0,
                      p2=0.0, k3=0.0, dtype=np.float64) -> np.ndarray:
    """Convenience constructor for the 9-vector intrinsics layout."""
    fy = fx if fy is None else fy
    return np.array([fx, fy, cx, cy, k1, k2, p1, p2, k3], dtype=dtype)


def project_camera_point(x_cam: torch.Tensor, intr: torch.Tensor,
                         model: CameraModel) -> torch.Tensor:
    """Camera-frame point → pixel. Shared tail of all projection paths."""
    z = x_cam[..., 2:3]
    xy = model.projection_sign * x_cam[..., :2] / z
    if model.use_distortion:
        xy = dist.distort(xy, intr[..., 4:9])
    return intr[..., 0:2] * xy + intr[..., 2:4]


def project_global(q: torch.Tensor, c: torch.Tensor, intr: torch.Tensor,
                   point: torch.Tensor, model: CameraModel) -> torch.Tensor:
    """Global-shutter world→pixel projection."""
    return project_camera_point(quat.rotate(q, point - c), intr, model)


def project_rolling(qa, ca, qb, cb, intr, point, t,
                    model: CameraModel) -> torch.Tensor:
    """Rolling-shutter world→pixel: interpolate the pose at t, project."""
    q, c = interpolate.interpolate_pose(qa, ca, qb, cb, t,
                                        model.rotation_interp)
    return project_global(q, c, intr, point, model)


def project(qa, ca, qb, cb, intr, point, t,
            model: CameraModel) -> torch.Tensor:
    """Rolling-shutter projection if the model says so, else global."""
    if model.rolling_shutter:
        return project_rolling(qa, ca, qb, cb, intr, point, t, model)
    return project_global(qa, ca, intr, point, model)


def depth_in_camera(qa, ca, qb, cb, point, t,
                    model: CameraModel) -> torch.Tensor:
    """z-depth of a world point in the (interpolated) camera frame; the
    sign follows projection_sign, positive means in front."""
    if model.rolling_shutter:
        q, c = interpolate.interpolate_pose(qa, ca, qb, cb, t,
                                            model.rotation_interp)
    else:
        q, c = qa, ca
    return model.projection_sign * quat.rotate(q, point - c)[..., 2]
