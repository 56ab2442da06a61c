"""Rolling-shutter PnP: register a new frame against the existing map.

Counterpart of ``rsba_tpu/solver/pnp.py``: the pose of a new frame from
2D-3D matches under the rolling-shutter model, with the map points held
fixed.  It is the trust-region LM loop on a two-pose problem with every
point block constant; the free masks make this a 12-dof (RS) or 6-dof
(GS) solve batched over all correspondences.

A rolling-shutter frame exposes between keyframe pose A (row 0) and pose
B (row H); both are estimated.  ``register_frame`` defaults the initial
guess of both to the supplied prior pose (for example the previous
frame's solution, the usual video-tracking prior).

Robustness: a robust ``loss`` (Huber by default) tolerates outlier
matches; the solver's Triggs correction downweights them as the full BA
does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import default_device
from ..geometry import CameraModel, Loss
from ..problem.types import (Observations, Params, intr_basis_fixed,
                             make_problem)
from . import lm
from .options import SolverOptions
from .summary import Summary


def default_options() -> SolverOptions:
    """The options of a registration when the caller gives none: a
    Schur-eliminated solve (the reduced camera system is 6- or 12-dof
    whatever the number of matches is) with tight tolerances."""
    return SolverOptions(linear_solver="dense_schur", max_iterations=50,
                         function_tolerance=1e-8)


def register_frame(
    points3d,
    uv,
    rows,
    intr,
    model: CameraModel,
    q_prior,
    c_prior,
    *,
    image_height: Optional[int] = None,
    q_b_prior=None,
    c_b_prior=None,
    loss: Loss = Loss("huber", 4.0),
    options: Optional[SolverOptions] = None,
    dtype=torch.float32,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, Summary]:
    """Estimate a new frame's pose(s) from 2D-3D correspondences.

    Args (host arrays):
      points3d: (M, 3) map points (held constant).
      uv: (M, 2) measured pixels.
      rows: (M,) measured image rows (shutter time t = row / H when
        ``model.rolling_shutter``; ignored for global shutter).
      intr: (9,) intrinsics vector (held constant).
      model: camera model (GS or RS, interpolation mode, distortion).
      q_prior, c_prior: initial pose guess (wxyz quaternion, center).
      image_height: required for rolling shutter (row → t).
      q_b_prior, c_b_prior: optional distinct initial guess for the row-H
        keyframe pose (default: the prior, a zero-velocity seed).
      loss: robust loss over the correspondences (default Huber, 4 px).
      options: solver knobs; default = ``default_options()``.
      device: None is the card (RuntimeError without one), "cpu" the CPU.

    Returns (q_a, c_a, q_b, c_b, summary), tensors on ``device``; for
    global shutter q_b/c_b equal q_a/c_a.
    """
    points3d = np.asarray(points3d)
    uv = np.asarray(uv)
    rows = np.asarray(rows)
    M = points3d.shape[0]
    if M < 3:
        raise ValueError(f"need >= 3 correspondences, got {M}")
    rs = model.rolling_shutter
    if rs and image_height is None:
        raise ValueError("image_height is required for rolling-shutter PnP")
    device = default_device(device)

    n_poses = 2 if rs else 1
    t = (np.clip(rows, 0, image_height) / float(image_height)
         if rs else np.zeros(M))

    # The correspondence count is padded to the next multiple of 32, so
    # that repeated registrations (every frame of an SfmSession) meet few
    # distinct shapes.
    Mp = -(-M // 32) * 32

    def pad(a, fill=0.0):
        a = np.asarray(a)
        return np.concatenate(
            [a, np.full((Mp - M,) + a.shape[1:], fill, a.dtype)])

    as_t = lambda a, dt=dtype: torch.as_tensor(  # noqa: E731
        np.asarray(a), device=device).to(dt)
    obs = Observations(
        uv=as_t(pad(uv)), t=as_t(pad(t)),
        pose_a=torch.zeros(Mp, dtype=torch.int32, device=device),
        pose_b=torch.full((Mp,), n_poses - 1, dtype=torch.int32,
                          device=device),
        intr_idx=torch.zeros(Mp, dtype=torch.int32, device=device),
        point=torch.arange(Mp, dtype=torch.int32, device=device),
        mask=as_t(pad(np.ones(M))))
    problem = make_problem(obs, n_poses, Mp, 1, model, loss,
                           intr_basis=intr_basis_fixed(), dtype=dtype,
                           device=device)
    # Pose-only solve: the map is constant.
    problem = problem.replace(point_free=torch.zeros(Mp, dtype=dtype,
                                                     device=device))

    qb = q_prior if q_b_prior is None else q_b_prior
    cb = c_prior if c_b_prior is None else c_b_prior
    host = lambda a: (a.detach().cpu().numpy()  # noqa: E731
                      if isinstance(a, torch.Tensor) else np.asarray(a))
    q0 = np.stack([host(q_prior)] + ([host(qb)] if rs else []))
    c0 = np.stack([host(c_prior)] + ([host(cb)] if rs else []))
    params0 = Params(q=as_t(q0), c=as_t(c0),
                     intr=as_t(host(intr)[None, :]),
                     # padded rows are masked out anyway
                     points=as_t(pad(points3d, fill=1.0)))

    params, summary = lm.solve(problem, params0,
                               options or default_options())
    return params.q[0], params.c[0], params.q[-1], params.c[-1], summary
