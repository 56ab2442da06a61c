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

import torch


def default_device(device=None) -> torch.device:
    """The device an entry point places its tensors on.

    ``None`` means the card: ``torch.device("cuda")``, or a RuntimeError
    when there is none (the port never carries on on the CPU by itself).
    Anything else, ``device="cpu"`` included, is taken as given.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "rsba_tpu_torch runs on a CUDA GPU by default and none is "
            'available; pass device="cpu" to ask for the CPU')
    return torch.device("cuda")


from . import geometry  # noqa: E402
from .geometry import CameraModel, Loss  # noqa: E402

__all__ = ["geometry", "CameraModel", "Loss", "default_device"]
