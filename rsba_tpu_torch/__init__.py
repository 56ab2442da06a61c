"""rsba_tpu_torch — rolling-shutter bundle adjustment in PyTorch and CUDA.

The PyTorch port of ``rsba_tpu`` for NVIDIA Hopper GPUs.  Module names
mirror ``rsba_tpu`` so each counterpart is easy to find; the JAX package
stays the reference every ported part is tested against.  This package
imports ``torch`` and never ``jax``.

The ported slice is the banded window solver (``linear_solver="auto"``
on video-style problems): geometry, problem types, the synthetic
generator, the window plan, the banded Schur engine and the fused
evaluate+assemble kernel (``kernels/fused.py``, CUDA source in
``csrc/``).
"""

__version__ = "0.1.0"

from . import geometry
from .geometry import CameraModel, Loss

__all__ = ["geometry", "CameraModel", "Loss"]
