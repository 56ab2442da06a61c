from . import (camera, distortion, epipolar, interpolate, losses, quaternion,
               triangulate)
from .camera import CameraModel, intrinsics_vector
from .losses import Loss

__all__ = [
    "camera", "distortion", "epipolar", "interpolate", "losses",
    "quaternion", "triangulate", "CameraModel", "intrinsics_vector", "Loss",
]
