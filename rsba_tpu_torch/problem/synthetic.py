"""Synthetic problem generators for the five config presets.

Counterpart of ``rsba_tpu/problem/synthetic.py``.  Every random number
comes from ``np.random.RandomState(seed)`` in the same order as the
reference, and the projection math is the same, so the generated problem
equals the reference's to float round-off in the working dtype.

Observations are produced with the package's own camera model, so the
converged RMSE floor equals the injected pixel noise.  Rolling-shutter
observations solve the row/pose fixed point v = proj_y(t = v/H) so the
measured row is consistent with the interpolated pose.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import default_device
from ..geometry import CameraModel, Loss, camera
from ..geometry import quaternion as quat
from .types import (Observations, Params, Problem, intr_basis_bal,
                    intr_basis_fixed, make_problem)


@dataclasses.dataclass
class SyntheticBA:
    problem: Problem
    params0: Params          # perturbed initial guess
    params_gt: Params        # ground truth
    image_size: tuple        # (W, H)
    pixel_noise: float       # σ of injected noise (the RMSE floor)
    name: str = ""


def _quats_from_R(R: np.ndarray) -> np.ndarray:
    """Batched rotation matrices (n,3,3) → wxyz quaternions (Shepperd)."""
    n = R.shape[0]
    tr = R[:, 0, 0] + R[:, 1, 1] + R[:, 2, 2]
    sA = np.sqrt(np.maximum(tr + 1.0, 1e-12)) * 2
    qA = np.stack([0.25 * sA, (R[:, 2, 1] - R[:, 1, 2]) / sA,
                   (R[:, 0, 2] - R[:, 2, 0]) / sA,
                   (R[:, 1, 0] - R[:, 0, 1]) / sA], axis=1)
    diag = np.stack([R[:, 0, 0], R[:, 1, 1], R[:, 2, 2]], axis=1)
    i = np.argmax(diag, axis=1)
    j, k = (i + 1) % 3, (i + 2) % 3
    ar = np.arange(n)
    sB = np.sqrt(np.maximum(
        R[ar, i, i] - R[ar, j, j] - R[ar, k, k] + 1.0, 1e-12)) * 2
    qB = np.zeros((n, 4))
    qB[:, 0] = (R[ar, k, j] - R[ar, j, k]) / sB
    qB[ar, 1 + i] = 0.25 * sB
    qB[ar, 1 + j] = (R[ar, j, i] + R[ar, i, j]) / sB
    qB[ar, 1 + k] = (R[ar, k, i] + R[ar, i, k]) / sB
    q = np.where((tr > 0)[:, None], qA, qB)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _lookat_quats(eyes: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Batched world→camera quaternions for cameras looking at `target`."""
    up = np.array([0.0, -1.0, 0.0])
    z = target[None, :] - eyes
    z = z / np.linalg.norm(z, axis=1, keepdims=True)
    x = np.cross(np.broadcast_to(up, z.shape), z)
    n = np.linalg.norm(x, axis=1, keepdims=True)
    x = np.where(n < 1e-9, np.array([1.0, 0.0, 0.0]),
                 x / np.maximum(n, 1e-12))
    y = np.cross(z, x)
    return _quats_from_R(np.stack([x, y, z], axis=1))


def _ring_trajectory(n_poses: int, radius: float, height_amp: float,
                     arc: float):
    """Smooth camera trajectory on an arc, looking at the origin, with
    quaternion signs kept continuous along it."""
    s = np.linspace(0.0, arc, n_poses)
    eye = np.stack([radius * np.cos(s), height_amp * np.sin(2.5 * s),
                    radius * np.sin(s)], axis=1)
    qs = _lookat_quats(eye, np.zeros(3))
    d = np.sum(qs[1:] * qs[:-1], axis=1)
    flip = np.concatenate([[1.0], np.cumprod(np.where(d >= 0, 1.0, -1.0))])
    return qs * flip[:, None], eye


def _observe_gt(params: Params, pa, pb, ii, pi, model: CameraModel, H: int,
                iters: int = 40, damping: float = 0.5):
    """GT observation pass: (t, row_gap, uv, depth).

    Rolling shutter solves v = proj_y(t = v/H) per observation with a
    damped fixed point of ``iters`` steps; ``row_gap`` = |proj_y(t)/H − t|·H
    px is the self-consistency of the measurement, and the caller drops
    observations whose gap stays above a fraction of a pixel.
    """
    qa, ca = params.q[pa], params.c[pa]
    qb, cb = params.q[pb], params.c[pb]
    intr = params.intr[ii]
    X = params.points[pi]
    dtype = params.points.dtype
    if model.rolling_shutter:
        t = torch.full(pi.shape, 0.5, dtype=dtype, device=X.device)
        for _ in range(iters):
            uv = camera.project(qa, ca, qb, cb, intr, X, t, model)
            t_new = torch.clamp(uv[:, 1] / H, 0.0, 1.0)
            t = (1.0 - damping) * t + damping * t_new
        uv_t = camera.project(qa, ca, qb, cb, intr, X, t, model)
        row_gap = torch.abs(torch.clamp(uv_t[:, 1] / H, 0.0, 1.0) - t) * H
    else:
        t = torch.zeros(pa.shape, dtype=dtype, device=X.device)
        row_gap = torch.zeros_like(t)
    uv_clean = camera.project(qa, ca, qb, cb, intr, X, t, model)
    depth = camera.depth_in_camera(qa, ca, qb, cb, X, t, model)
    return t, row_gap, uv_clean, depth


def _perturb(params: Params, rng: np.random.RandomState, rot_sigma: float,
             trans_sigma: float, point_sigma: float,
             intr_f_sigma: float = 0.0, intr_k_sigma: float = 0.0) -> Params:
    P, M = params.n_poses, params.n_points
    dev, dt = params.device, params.dtype
    dq = torch.as_tensor(rng.randn(P, 3) * rot_sigma, device=dev).to(dt)
    q = quat.boxplus(params.q, dq)
    c = params.c + torch.as_tensor(rng.randn(P, 3) * trans_sigma,
                                   dtype=dt, device=dev)
    pts = params.points + torch.as_tensor(rng.randn(M, 3) * point_sigma,
                                          dtype=dt, device=dev)
    intr = params.intr
    if intr_f_sigma > 0 or intr_k_sigma > 0:
        d = np.zeros((intr.shape[0], 9))
        d[:, 0] = d[:, 1] = rng.randn(intr.shape[0]) * intr_f_sigma
        d[:, 4] = rng.randn(intr.shape[0]) * intr_k_sigma
        d[:, 5] = rng.randn(intr.shape[0]) * intr_k_sigma
        intr = intr + torch.as_tensor(d, dtype=dt, device=dev)
    return Params(q=q, c=c, intr=intr, points=pts)


def make_ba_problem(
    n_poses: int,
    n_points: int,
    track_len: int,
    *,
    rolling_shutter: bool = False,
    rotation_interp: str = "slerp",
    use_distortion: bool = False,
    per_camera_intrinsics: bool = False,
    optimize_intrinsics: bool = False,
    loss: Loss = Loss(),
    outlier_fraction: float = 0.0,
    pixel_noise: float = 0.5,
    image_size=(1024, 768),
    focal: float = 900.0,
    seed: int = 0,
    dtype=torch.float64,
    device=None,
    rot_sigma: float = 0.01,
    trans_sigma: float = 0.02,
    point_sigma: float = 0.02,
    pad_to: int = 256,
    name: str = "",
) -> SyntheticBA:
    """General synthetic BA generator behind all config presets.

    Video semantics when rolling_shutter: ``n_poses`` keyframe poses and
    ``n_poses − 1`` frames; frame i exposes between pose i (row 0) and
    pose i+1 (row H).  Each point is seen by a contiguous window of frames.
    Global shutter: every pose is a frame, pose_b == pose_a, t == 0.
    """
    device = default_device(device)
    rng = np.random.RandomState(seed)
    W, H = image_size
    n_frames = n_poses - 1 if rolling_shutter else n_poses
    model = CameraModel(rolling_shutter=rolling_shutter,
                        rotation_interp=rotation_interp,
                        use_distortion=use_distortion)
    as_t = lambda a, dt=dtype: torch.as_tensor(  # noqa: E731
        np.asarray(a), dtype=dt, device=device)

    # --- ground-truth scene ------------------------------------------------
    arc = min(2.0 * np.pi, 0.02 * n_frames + 0.5)
    qs, cs = _ring_trajectory(n_poses, 2.0, 0.15, arc)
    pts = rng.randn(n_points, 3)
    pts = pts / np.maximum(np.linalg.norm(pts, axis=1, keepdims=True), 1.0)
    pts *= 0.9

    n_intr = n_frames if per_camera_intrinsics else 1
    intr = np.zeros((n_intr, 9))
    intr[:, 0] = intr[:, 1] = focal * (1.0 + 0.05 * rng.randn(n_intr)
                                       if per_camera_intrinsics else 1.0)
    intr[:, 2] = W / 2.0
    intr[:, 3] = H / 2.0
    if use_distortion:
        intr[:, 4] = -0.15 + 0.02 * rng.randn(n_intr)   # k1
        intr[:, 5] = 0.03 + 0.005 * rng.randn(n_intr)   # k2
        intr[:, 6] = 1e-3 * rng.randn(n_intr)           # p1
        intr[:, 7] = 1e-3 * rng.randn(n_intr)           # p2
    params_gt = Params(q=as_t(qs), c=as_t(cs), intr=as_t(intr),
                       points=as_t(pts))

    # --- tracks: contiguous frame windows per point ------------------------
    start = rng.randint(0, max(n_frames - track_len + 1, 1), size=n_points)
    frame_idx = start[:, None] + np.arange(track_len)[None, :]
    frame_idx = np.minimum(frame_idx, n_frames - 1)
    point_idx = np.repeat(np.arange(n_points), track_len)
    pose_a = frame_idx.reshape(-1)
    pose_b = pose_a + 1 if rolling_shutter else pose_a
    intr_idx = pose_a if per_camera_intrinsics else np.zeros_like(pose_a)

    # --- observations: project GT (fixed-point row time for RS) ------------
    idx = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    t, row_gap, uv_clean, depth = _observe_gt(
        params_gt, idx(pose_a), idx(pose_b), idx(intr_idx), idx(point_idx),
        model, H)
    uv_clean = uv_clean.cpu().numpy()
    valid = (depth.cpu().numpy() > 0.2) & np.isfinite(uv_clean).all(axis=1)
    valid &= ((uv_clean[:, 0] >= 0) & (uv_clean[:, 0] < W)
              & (uv_clean[:, 1] >= 0) & (uv_clean[:, 1] < H))
    valid &= row_gap.cpu().numpy() < 0.25

    uv = uv_clean + rng.randn(*uv_clean.shape) * pixel_noise
    if outlier_fraction > 0:
        out = rng.rand(uv.shape[0]) < outlier_fraction
        uv[out, 0] = rng.rand(out.sum()) * W
        uv[out, 1] = rng.rand(out.sum()) * H
    t_meas = (np.clip(uv[:, 1], 0, H) / H if rolling_shutter
              else np.zeros(uv.shape[0]))

    # keep only valid, then pad to a static multiple
    keep = np.nonzero(valid)[0]
    n_keep = keep.shape[0]
    total = n_keep + (-n_keep % pad_to)

    def pad(a, dt):
        out = np.zeros((total,) + a.shape[1:], dtype=a.dtype)
        out[:n_keep] = a[keep]
        return as_t(out, dt)

    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    obs = Observations(
        uv=pad(uv.astype(np_dtype), dtype),
        t=pad(t_meas.astype(np_dtype), dtype),
        pose_a=pad(pose_a.astype(np.int32), torch.int32),
        pose_b=pad(pose_b.astype(np.int32), torch.int32),
        intr_idx=pad(intr_idx.astype(np.int32), torch.int32),
        point=pad(point_idx.astype(np.int32), torch.int32),
        mask=pad(np.ones(uv.shape[0], dtype=np_dtype), dtype))
    basis = (intr_basis_bal(np_dtype) if optimize_intrinsics
             else intr_basis_fixed(np_dtype))
    problem = make_problem(obs, n_poses, n_points, n_intr, model, loss,
                           intr_basis=basis, dtype=dtype, device=device)

    params0 = _perturb(
        params_gt, rng, rot_sigma, trans_sigma, point_sigma,
        intr_f_sigma=0.01 * focal if optimize_intrinsics else 0.0,
        intr_k_sigma=0.01 if optimize_intrinsics else 0.0)
    # Gauge fixing: hold the first pose constant.
    pose_free = problem.pose_free.clone()
    pose_free[0] = 0.0
    problem = problem.replace(pose_free=pose_free)
    q0, c0 = params0.q.clone(), params0.c.clone()
    q0[0], c0[0] = params_gt.q[0], params_gt.c[0]
    params0 = params0.replace(q=q0, c=c0)
    return SyntheticBA(problem=problem, params0=params0, params_gt=params_gt,
                       image_size=image_size, pixel_noise=pixel_noise,
                       name=name)


# --- The five config presets -------------------------------------------------

def config1_gs_small(scale=1.0, seed=0, dtype=torch.float64, device=None):
    """Global-shutter pinhole BA, 50 cams / 5k pts."""
    return make_ba_problem(
        n_poses=max(int(50 * scale), 4), n_points=max(int(5000 * scale), 50),
        track_len=8, rolling_shutter=False, use_distortion=False,
        pixel_noise=0.5, seed=seed, dtype=dtype, device=device,
        name="gs_small")


def config2_gs_bal(scale=1.0, seed=0, dtype=torch.float64, device=None):
    """GS + distortion, BAL-style ~100 cams / 50k pts, per-camera
    optimizable [f, k1, k2] intrinsics (the ``dense_schur`` preset)."""
    return make_ba_problem(
        n_poses=max(int(100 * scale), 4),
        n_points=max(int(50000 * scale), 100),
        track_len=10, rolling_shutter=False, use_distortion=True,
        per_camera_intrinsics=True, optimize_intrinsics=True,
        pixel_noise=0.5, seed=seed, dtype=dtype, device=device,
        name="gs_bal")


def config3_rs_video(scale=1.0, seed=0, dtype=torch.float64, device=None):
    """Rolling-shutter linear interpolation, 200-frame video sequence."""
    n_frames = max(int(200 * scale), 4)
    return make_ba_problem(
        n_poses=n_frames + 1, n_points=max(int(20000 * scale), 100),
        track_len=12, rolling_shutter=True, rotation_interp="nlerp",
        use_distortion=False, pixel_noise=0.5, seed=seed, dtype=dtype,
        device=device, rot_sigma=0.005, trans_sigma=0.01, point_sigma=0.01,
        name="rs_video_linear")


def config4_rs_slerp(scale=1.0, seed=0, dtype=torch.float64, device=None):
    """RS SLERP + distortion, 1k cams / 100k pts, robust Huber loss."""
    n_frames = max(int(1000 * scale), 4)
    return make_ba_problem(
        n_poses=n_frames + 1, n_points=max(int(100000 * scale), 100),
        track_len=10, rolling_shutter=True, rotation_interp="slerp",
        use_distortion=True, loss=Loss("huber", 4.0),
        outlier_fraction=0.05, pixel_noise=0.5, seed=seed, dtype=dtype,
        device=device, rot_sigma=0.005, trans_sigma=0.01, point_sigma=0.01,
        name="rs_slerp_robust")


def config5_rs_large(scale=1.0, seed=0, dtype=torch.float32, device=None):
    """Multi-host-scale RS BA, 10k cams / 1M pts."""
    n_frames = max(int(10000 * scale), 8)
    return make_ba_problem(
        n_poses=n_frames + 1, n_points=max(int(1000000 * scale), 200),
        track_len=8, rolling_shutter=True, rotation_interp="slerp",
        use_distortion=True, loss=Loss("huber", 4.0),
        pixel_noise=0.5, seed=seed, dtype=dtype, device=device,
        rot_sigma=0.002, trans_sigma=0.005, point_sigma=0.005,
        pad_to=8192, name="rs_mhost_pcg")


CONFIGS = {
    "gs_small": config1_gs_small,
    "gs_bal": config2_gs_bal,
    "rs_video_linear": config3_rs_video,
    "rs_slerp_robust": config4_rs_slerp,
    "rs_mhost_pcg": config5_rs_large,
}
