"""Problem data model: parameters, observations and the batched problem.

Counterpart of ``rsba_tpu/problem/types.py``, as plain dataclasses of
torch tensors.  Block structure:

* pose blocks — ``n_poses`` unit quaternions (wxyz) plus camera centers,
  tangent dim 6 (3 rotation ⊞, 3 translation);
* intrinsics blocks — 9-vectors (camera.py layout); tangent dim
  ``intr_tangent_dim`` through a static (9, ni) basis: 0 columns hold
  them fixed, ``intr_basis_bal`` ties the focal to [f, k1, k2], and
  ``intr_basis_subset`` frees any subset, for example to self-calibrate
  one camera shared by every frame;
* point blocks — ``n_points`` 3-vectors (the Schur-eliminated group).

Each observation references (pose_a, pose_b, intr, point) and carries
its row-normalized shutter time t; padding rows have mask = 0.

``params_from_numpy`` / ``problem_from_numpy`` / ``to_numpy`` carry state
between this package and any object with the same field names (for
example the JAX package's pytrees) as numpy arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import default_device
from ..geometry import CameraModel, Loss
from ..geometry.camera import NUM_INTR

#: tangent dims per pose block (3 rotation + 3 translation)
POSE_DOF = 6
#: dims per point block
POINT_DOF = 3


class _Replace:
    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class Params(_Replace):
    """Optimizable parameters."""
    q: torch.Tensor        # (P, 4) unit quaternions, wxyz
    c: torch.Tensor        # (P, 3) camera centers (world)
    intr: torch.Tensor     # (K, 9) intrinsics vectors
    points: torch.Tensor   # (M, 3) world points

    @property
    def n_poses(self) -> int:
        return self.q.shape[0]

    @property
    def n_points(self) -> int:
        return self.points.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.points.dtype

    @property
    def device(self) -> torch.device:
        return self.points.device

    def astype(self, dtype) -> "Params":
        """The same parameters in ``dtype``, each on its own device."""
        return Params(*(getattr(self, f).to(dtype)
                        for f in ("q", "c", "intr", "points")))


@dataclasses.dataclass
class Observations(_Replace):
    """Structure-of-arrays observation table, statically padded."""
    uv: torch.Tensor        # (N, 2) measured pixels
    t: torch.Tensor         # (N,)   shutter time in [0, 1] (0 for GS)
    pose_a: torch.Tensor    # (N,)   int32 first keyframe pose index
    pose_b: torch.Tensor    # (N,)   int32 second keyframe pose index
    intr_idx: torch.Tensor  # (N,)   int32 intrinsics block index
    point: torch.Tensor     # (N,)   int32 point index
    mask: torch.Tensor      # (N,)   1.0 valid / 0.0 padding

    @property
    def n_obs(self) -> int:
        return self.uv.shape[0]


@dataclasses.dataclass
class Problem(_Replace):
    """A batched bundle-adjustment problem."""
    obs: Observations
    pose_free: torch.Tensor    # (P,) 1.0 free / 0.0 constant
    point_free: torch.Tensor   # (M,) 1.0 free / 0.0 constant
    intr_free: torch.Tensor    # (K,) 1.0 free / 0.0 constant
    intr_basis: torch.Tensor   # (9, ni) tangent basis; ni == 0 → fixed
    model: CameraModel = CameraModel()
    loss: Loss = Loss()

    @property
    def intr_tangent_dim(self) -> int:
        return self.intr_basis.shape[1]

    @property
    def device(self) -> torch.device:
        return self.pose_free.device

    def cam_tangent_dim(self, params: Params) -> int:
        """Total camera-side tangent dimension (poses + intrinsics)."""
        return (POSE_DOF * params.n_poses
                + self.intr_tangent_dim * params.intr.shape[0])


def intr_basis_fixed(dtype=np.float32) -> np.ndarray:
    """Intrinsics held constant."""
    return np.zeros((9, 0), dtype=dtype)


def intr_basis_bal(dtype=np.float32) -> np.ndarray:
    """BAL-style [f, k1, k2] tangent: one focal driving fx and fy."""
    b = np.zeros((9, 3), dtype=dtype)
    b[0, 0] = b[1, 0] = 1.0
    b[4, 1] = 1.0
    b[5, 2] = 1.0
    return b


def intr_basis_full(dtype=np.float32) -> np.ndarray:
    """All 9 intrinsics free."""
    return np.eye(NUM_INTR, dtype=dtype)


def intr_basis_subset(indices, tie_focal: bool = False,
                      dtype=np.float32) -> np.ndarray:
    """Free exactly the given intrinsics indices (camera.py layout order).

    With ``tie_focal`` and index 0 among them, one first column drives fx
    and fy together, and indices 0 and 1 get no column of their own."""
    idx = list(indices)
    cols = []
    if tie_focal and 0 in idx:
        cols.append([0, 1])
        idx = [i for i in idx if i not in (0, 1)]
    cols += [[i] for i in idx]
    b = np.zeros((NUM_INTR, len(cols)), dtype=dtype)
    for j, rows in enumerate(cols):
        b[rows, j] = 1.0
    return b


def make_problem(obs: Observations, n_poses: int, n_points: int,
                 n_intr: int, model: CameraModel, loss: Loss = Loss(),
                 intr_basis: Optional[np.ndarray] = None,
                 dtype=torch.float32, device=None) -> Problem:
    """Assemble a Problem with everything free by default."""
    if intr_basis is None:
        intr_basis = intr_basis_fixed()
    device = obs.uv.device if device is None else device
    ones = lambda n: torch.ones((n,), dtype=dtype, device=device)  # noqa: E731
    problem = Problem(
        obs=obs, pose_free=ones(n_poses), point_free=ones(n_points),
        intr_free=ones(n_intr),
        intr_basis=torch.as_tensor(np.asarray(intr_basis), dtype=dtype,
                                   device=device),
        model=model, loss=loss)
    validate_problem(problem)
    return problem


def validate_problem(problem: Problem) -> None:
    """Structural sanity checks: shapes, index ranges and finite
    observation data.  Raises ValueError on the first violation.  The
    checks reduce over the observations where they live; the host reads
    back one small tensor of their results."""
    obs = problem.obs
    N = obs.n_obs
    for name in ("t", "pose_a", "pose_b", "intr_idx", "point", "mask"):
        a = getattr(obs, name)
        if a.shape[0] != N:
            raise ValueError(f"obs.{name} has {a.shape[0]} rows, uv has {N}")
    if tuple(obs.uv.shape) != (N, 2):
        raise ValueError(f"obs.uv must be (N, 2), got {tuple(obs.uv.shape)}")
    P = problem.pose_free.shape[0]
    M = problem.point_free.shape[0]
    K = problem.intr_free.shape[0]
    ranges = (("pose_a", P), ("pose_b", P), ("intr_idx", K), ("point", M))
    (n_valid, *bounds, uv_finite, t_lo, t_hi,
     pb_before_pa) = _validity_stats(obs, [n for n, _ in ranges]) \
        if N else (0,) * (2 * len(ranges) + 5)
    for (name, hi), lo_, hi_ in zip(ranges, bounds[0::2], bounds[1::2]):
        lo_, hi_ = int(lo_), int(hi_)
        if n_valid and (lo_ < 0 or hi_ >= hi):
            raise ValueError(
                f"obs.{name} out of range [0, {hi}): [{lo_}, {hi_}]")
    if problem.intr_basis.shape[0] != 9:
        raise ValueError(
            f"intr_basis must be (9, ni), got "
            f"{tuple(problem.intr_basis.shape)}")
    if n_valid and not uv_finite:
        raise ValueError("non-finite pixel coordinates in valid obs")
    if n_valid and (t_lo < 0.0 or t_hi > 1.0):
        raise ValueError(f"shutter time t outside [0, 1]: [{t_lo}, {t_hi}]")
    if problem.model.rolling_shutter and n_valid and pb_before_pa:
        raise ValueError("rolling shutter requires pose_b >= pose_a")


def _validity_stats(obs: Observations, index_names) -> list:
    """Over the valid observations: their count, the least and largest of
    each index array in ``index_names``, whether every pixel is finite,
    the least and largest shutter time, and whether any pose_b lies
    before its pose_a; reduced on the observations' device and read back
    as one float64 tensor (indices below 2**53 are exact)."""
    valid = obs.mask > 0
    big = 2.0 ** 62
    f64 = lambda a: a.to(torch.float64)  # noqa: E731
    stats = [valid.sum()]
    for name in index_names:
        a = f64(getattr(obs, name))
        stats += [torch.where(valid, a, big).min(),
                  torch.where(valid, a, -big).max()]
    t = f64(obs.t)
    stats += [torch.where(valid[:, None], torch.isfinite(obs.uv), True).all(),
              torch.where(valid, t, big).min(),
              torch.where(valid, t, -big).max(),
              (valid & (obs.pose_b < obs.pose_a)).any()]
    return torch.stack([f64(x) for x in stats]).cpu().tolist()


# --- numpy bridges -----------------------------------------------------------

_OBS_INT = ("pose_a", "pose_b", "intr_idx", "point")


def _tensor(a, dtype, device) -> torch.Tensor:
    """An array field (numpy, a JAX array, or a tensor on any device) as a
    tensor of ``dtype`` on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device=device, dtype=dtype)
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def params_from_numpy(src, *, device=None, dtype=torch.float64) -> Params:
    """Params from any object with q/c/intr/points array fields (this
    package's own Params included: a change of dtype or device)."""
    device = default_device(device)
    return Params(*(_tensor(getattr(src, f), dtype, device)
                    for f in ("q", "c", "intr", "points")))


def problem_from_numpy(src, *, device=None, dtype=torch.float64) -> Problem:
    """Problem from any object with this module's Problem field names
    (obs.uv …, pose_free …, model, loss)."""
    device = default_device(device)

    def arr(a, dt):
        return _tensor(a, dt, device)

    o = src.obs
    obs = Observations(**{
        f: arr(getattr(o, f), torch.int32 if f in _OBS_INT else dtype)
        for f in ("uv", "t", "pose_a", "pose_b", "intr_idx", "point",
                  "mask")})
    m, lo = src.model, src.loss
    problem = Problem(
        obs=obs, pose_free=arr(src.pose_free, dtype),
        point_free=arr(src.point_free, dtype),
        intr_free=arr(src.intr_free, dtype),
        intr_basis=arr(src.intr_basis, dtype),
        model=CameraModel(rolling_shutter=m.rolling_shutter,
                          rotation_interp=m.rotation_interp,
                          use_distortion=m.use_distortion,
                          projection_sign=m.projection_sign),
        loss=Loss(lo.kind, lo.scale))
    validate_problem(problem)
    return problem


def to_numpy(x) -> dict:
    """Params or Problem → dict of numpy arrays (``obs`` nested; model
    and loss passed through)."""
    out = {}
    for f in dataclasses.fields(x):
        v = getattr(x, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = v.detach().cpu().numpy()
        elif dataclasses.is_dataclass(v) and isinstance(v, _Replace):
            out[f.name] = to_numpy(v)
        else:
            out[f.name] = v
    return out
