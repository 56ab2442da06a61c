"""Bundle Adjustment in the Large (BAL) problem file I/O.

Counterpart of ``rsba_tpu/io/bal.py``: the standard BAL text format
(https://grail.cs.washington.edu/projects/bal/):

    <n_cams> <n_points> <n_obs>
    <cam_idx> <pt_idx> <u> <v>          × n_obs
    <9 camera params: aa(3) t(3) f k1 k2>  × n_cams (one value per line)
    <3 point coords>                        × n_points

BAL camera convention: X_cam = R(aa)·X + t, camera looks down −z
(p = −X_cam.xy/X_cam.z), radial-only distortion 1 + k1 r² + k2 r⁴, pixels
centred at the principal point.  Converted here into the package's
convention (q, c = −Rᵀt, projection_sign = −1, intrinsics
[f, f, 0, 0, k1, k2, 0, 0, 0]).  The file is parsed and converted on the
host in float64; the tensors then go to the device in the asked dtype.
"""
from __future__ import annotations

import gzip

import numpy as np
import torch

from .. import default_device
from ..geometry import CameraModel, Loss
from ..geometry import quaternion as quat
from ..problem.types import (Observations, Params, Problem, intr_basis_bal,
                             intr_basis_fixed, make_problem)

BAL_CAMERA_MODEL = CameraModel(rolling_shutter=False, use_distortion=True,
                               projection_sign=-1.0)


def _open(path: str, mode: str = "rt"):
    p = str(path)
    if p.endswith(".gz"):
        return gzip.open(path, mode)
    if p.endswith(".bz2"):
        import bz2
        return bz2.open(path, mode)
    return open(path, mode)


def load_bal(path: str, *, loss: Loss = Loss("huber", 4.0),
             optimize_intrinsics: bool = True, dtype=torch.float64,
             pad_to: int = 1024, fix_gauge: bool = True, device=None):
    """Load a BAL problem file → (Problem, Params).

    The problem is in the package's convention with per-camera intrinsics
    blocks; the initial parameters are the file's.  ``device=None`` is
    the card (RuntimeError without one); pass ``device="cpu"`` for the
    CPU.
    """
    device = default_device(device)
    with _open(path) as f:
        tokens = f.read().split()
    n_cams, n_pts, n_obs = (int(x) for x in tokens[:3])
    end_obs = 3 + 4 * n_obs
    end_cams = end_obs + 9 * n_cams
    end_pts = end_cams + 3 * n_pts
    if len(tokens) < end_pts:
        raise ValueError(
            f"{path}: header promises {end_pts} values, file has "
            f"{len(tokens)}")
    obs_tok = np.array(tokens[3:end_obs]).reshape(n_obs, 4)
    cam_idx = obs_tok[:, 0].astype(np.int32)
    pt_idx = obs_tok[:, 1].astype(np.int32)
    uv = obs_tok[:, 2:4].astype(np.float64)
    cam_params = np.array(tokens[end_obs:end_cams],
                          np.float64).reshape(n_cams, 9)
    points = np.array(tokens[end_cams:end_pts], np.float64).reshape(n_pts, 3)

    t = torch.as_tensor(cam_params[:, 3:6])
    q = quat.from_axis_angle(torch.as_tensor(cam_params[:, 0:3]))
    # c = −Rᵀ t  (the pose stores the camera centre)
    c = -quat.rotate_inverse(q, t)
    intr = np.zeros((n_cams, 9))
    intr[:, 0] = intr[:, 1] = cam_params[:, 6]   # f
    intr[:, 4] = cam_params[:, 7]                # k1
    intr[:, 5] = cam_params[:, 8]                # k2

    as_t = lambda a, dt=dtype: torch.as_tensor(  # noqa: E731
        np.asarray(a), device=device).to(dt)
    params = Params(q=as_t(q), c=as_t(c), intr=as_t(intr),
                    points=as_t(points))

    total = n_obs + (-n_obs % pad_to)

    def pad(a, dt):
        out = np.zeros((total,) + a.shape[1:], dtype=a.dtype)
        out[:n_obs] = a
        return as_t(out, dt)

    cam = pad(cam_idx, torch.int32)
    obs = Observations(
        uv=pad(uv, dtype), t=as_t(np.zeros(total), dtype),
        pose_a=cam, pose_b=cam.clone(), intr_idx=cam.clone(),
        point=pad(pt_idx, torch.int32), mask=pad(np.ones(n_obs), dtype))
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    basis = (intr_basis_bal(np_dtype) if optimize_intrinsics
             else intr_basis_fixed(np_dtype))
    problem = make_problem(obs, n_cams, n_pts, n_cams, BAL_CAMERA_MODEL,
                           loss, intr_basis=basis, dtype=dtype, device=device)
    if fix_gauge:
        pose_free = problem.pose_free.clone()
        pose_free[0] = 0.0
        problem = problem.replace(pose_free=pose_free)
    return problem, params


def save_bal(path: str, problem: Problem, params: Params) -> None:
    """Write (problem, params) back to BAL text format (inverse of load).

    Refuses problems that BAL's 9-parameter camera cannot represent (another
    projection convention, a principal point, tangential or k3 distortion,
    fx ≠ fy) rather than dropping information.
    """
    if problem.model != BAL_CAMERA_MODEL:
        raise ValueError(
            "save_bal requires the BAL camera convention "
            f"({BAL_CAMERA_MODEL}), got {problem.model}")
    host = lambda a: a.detach().cpu().numpy()  # noqa: E731
    intr = host(params.intr)
    lossy = (np.abs(intr[:, 2:4]).max() > 0          # cx, cy
             or np.abs(intr[:, 6:9]).max() > 0       # p1, p2, k3
             or np.abs(intr[:, 0] - intr[:, 1]).max() > 0)  # fx≠fy
    if lossy:
        raise ValueError("BAL format cannot represent principal point, "
                         "tangential/k3 distortion, or fx≠fy")
    obs = problem.obs
    mask = host(obs.mask) > 0
    cam_idx = host(obs.pose_a)[mask]
    pt_idx = host(obs.point)[mask]
    uv = host(obs.uv)[mask]
    aa = host(quat.to_axis_angle(params.q))
    t = -host(quat.rotate(params.q, params.c))
    pts = host(params.points)
    n_cams = aa.shape[0]
    with _open(path, "wt") as f:
        f.write(f"{n_cams} {pts.shape[0]} {mask.sum()}\n")
        for i in range(mask.sum()):
            f.write(f"{cam_idx[i]} {pt_idx[i]} {uv[i, 0]:.12g} "
                    f"{uv[i, 1]:.12g}\n")
        for k in range(n_cams):
            vals = list(aa[k]) + list(t[k]) + [intr[k, 0], intr[k, 4],
                                               intr[k, 5]]
            f.write("\n".join(f"{v:.16e}" for v in vals) + "\n")
        for p in pts:
            f.write("\n".join(f"{v:.16e}" for v in p) + "\n")


def export_ply(path: str, params: Params,
               point_color=(200, 200, 200), cam_color=(255, 64, 64)) -> None:
    """Export the reconstruction (points and camera centres) as an ASCII
    PLY cloud."""
    pts = params.points.detach().cpu().numpy()
    cams = params.c.detach().cpu().numpy()
    n = pts.shape[0] + cams.shape[0]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\n"
                "property uchar blue\nend_header\n")
        for xyz, col in ((pts, point_color), (cams, cam_color)):
            for p in xyz:
                f.write(f"{p[0]:.6g} {p[1]:.6g} {p[2]:.6g} "
                        f"{col[0]} {col[1]} {col[2]}\n")
