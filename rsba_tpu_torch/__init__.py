"""rsba_tpu_torch — rolling-shutter bundle adjustment in PyTorch and CUDA.

The PyTorch port of ``rsba_tpu`` for NVIDIA Hopper GPUs.  Module names
mirror ``rsba_tpu`` so each counterpart is easy to find; the JAX package
stays the reference every ported part is tested against.  This package
imports ``torch`` and never ``jax``.

Ported: geometry, problem types, the synthetic generator, the whole
solver, what stands around it, and the sharded solvers.  The solver: the
banded window engine (``linear_solver="auto"`` on video-style problems)
with the fused evaluate+assemble kernel (``kernels/fused.py``, CUDA source in
``csrc/``), the flat ``dense``, ``dense_schur`` and ``iterative_schur``
engines, the Schur-Jacobi and cluster-Jacobi preconditioners, dogleg,
and the on-device LM loop (``solver/lm_device.py``), which on a CUDA
problem is replayed from CUDA graphs.  Around it: covariance and the
gradient check, BAL file I/O and PLY export (``io``), checkpoints and
the roofline report (``utils``), triangulation, the two-view bootstrap,
P3P, PnP and RANSAC registration, the incremental video-SfM session
(``pipeline.SfmSession``) and the command line (``cli.run``).  The
sharded solvers (``dist``) run on ``torch.distributed``, one process per
rank: the banded window solver split by trajectory rows, with the fused
kernel on each rank's rows, and the flat solvers split by landmarks;
``entry`` holds the counterparts of ``__graft_entry__.py``.
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
from .geometry import CameraModel, Loss, intrinsics_vector  # noqa: E402

__all__ = ["geometry", "CameraModel", "Loss", "intrinsics_vector",
           "default_device", "SfmSession"]


def __getattr__(name):
    # Lazy: the pipeline pulls in the solver stack; a bare import of the
    # package stays light for geometry-only users.
    if name == "SfmSession":
        from .pipeline import SfmSession
        return SfmSession
    raise AttributeError(name)
