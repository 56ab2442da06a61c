from . import camera, distortion, interpolate, losses, quaternion
from .camera import CameraModel
from .losses import Loss

__all__ = ["camera", "distortion", "interpolate", "losses", "quaternion",
           "CameraModel", "Loss"]
