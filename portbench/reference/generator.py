"""The benchmark's frozen copy of the synthetic problem generator.

It draws every random number from ``np.random.RandomState(seed)`` in the
order of the program's generator (``problem/synthetic.py``), and projects
with this package's own geometry, so that at the same parameters and in
float64 it gives the program's ``CONFIGS`` problems; the benchmark's
tests hold it to that.  It imports nothing of the program: the inputs of
both sides are made here and handed to each.

``make_scene`` returns host arrays (float64 and int32).  The ground-truth
observation pass runs in float64 on the device it is given.

Scene semantics: under rolling shutter, ``n_poses`` keyframe poses and
``n_poses − 1`` frames, frame i exposing from pose i (row 0) to pose i+1
(row H); each point is seen by a contiguous run of ``track_len`` frames.
Pose 0 is held constant (the gauge) and starts at the ground truth.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import geometry as geo


@dataclasses.dataclass
class Scene:
    model: dict            # rolling_shutter, interp, distortion
    loss: dict             # kind ("trivial" | "huber"), scale
    image_size: tuple      # (W, H)
    pixel_noise: float
    # observations, padded with mask == 0 rows
    uv: np.ndarray         # (N, 2)
    t: np.ndarray          # (N,)
    pose_a: np.ndarray     # (N,) int32
    pose_b: np.ndarray     # (N,) int32
    point: np.ndarray      # (N,) int32
    mask: np.ndarray       # (N,)
    pose_free: np.ndarray  # (P,)
    intr: np.ndarray       # (1, 9), held constant
    gt: dict               # q (P, 4), c (P, 3), points (M, 3)
    start: dict            # the perturbed start, same keys

    @property
    def n_poses(self) -> int:
        return self.gt["q"].shape[0]

    @property
    def n_points(self) -> int:
        return self.gt["points"].shape[0]

    @property
    def n_valid(self) -> int:
        return int((self.mask > 0).sum())


def _quats_from_R(R: np.ndarray) -> np.ndarray:
    """Rotation matrices (n, 3, 3) → unit quaternions, Shepperd's method:
    the trace form where the trace is positive, else the largest
    diagonal's."""
    n = R.shape[0]
    tr = R[:, 0, 0] + R[:, 1, 1] + R[:, 2, 2]
    sa = np.sqrt(np.maximum(tr + 1.0, 1e-12)) * 2
    qa = np.stack([0.25 * sa, (R[:, 2, 1] - R[:, 1, 2]) / sa,
                   (R[:, 0, 2] - R[:, 2, 0]) / sa,
                   (R[:, 1, 0] - R[:, 0, 1]) / sa], axis=1)
    i = np.argmax(np.stack([R[:, 0, 0], R[:, 1, 1], R[:, 2, 2]], axis=1),
                  axis=1)
    j, k = (i + 1) % 3, (i + 2) % 3
    ar = np.arange(n)
    sb = np.sqrt(np.maximum(R[ar, i, i] - R[ar, j, j] - R[ar, k, k] + 1.0,
                            1e-12)) * 2
    qb = np.zeros((n, 4))
    qb[:, 0] = (R[ar, k, j] - R[ar, j, k]) / sb
    qb[ar, 1 + i] = 0.25 * sb
    qb[ar, 1 + j] = (R[ar, j, i] + R[ar, i, j]) / sb
    qb[ar, 1 + k] = (R[ar, k, i] + R[ar, i, k]) / sb
    q = np.where((tr > 0)[:, None], qa, qb)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _trajectory(n_poses: int, arc: float):
    """Cameras on an arc of radius 2 with a small vertical wave, looking
    at the origin, quaternion signs continuous along the arc."""
    s = np.linspace(0.0, arc, n_poses)
    eye = np.stack([2.0 * np.cos(s), 0.15 * np.sin(2.5 * s),
                    2.0 * np.sin(s)], axis=1)
    z = -eye / np.linalg.norm(eye, axis=1, keepdims=True)
    x = np.cross(np.broadcast_to(np.array([0.0, -1.0, 0.0]), z.shape), z)
    nx = np.linalg.norm(x, axis=1, keepdims=True)
    x = np.where(nx < 1e-9, np.array([1.0, 0.0, 0.0]),
                 x / np.maximum(nx, 1e-12))
    q = _quats_from_R(np.stack([x, np.cross(z, x), z], axis=1))
    d = np.sum(q[1:] * q[:-1], axis=1)
    flip = np.concatenate([[1.0], np.cumprod(np.where(d >= 0, 1.0, -1.0))])
    return q * flip[:, None], eye


def make_scene(p: dict, seed: int, device="cpu") -> Scene:
    """One problem from the generator parameters ``p`` (a configuration's
    ``generator`` group) and ``seed`` (0 ≤ seed < 2**32)."""
    dev = torch.device(device)
    rng = np.random.RandomState(seed)
    W, H = p.get("image_size", (1024, 768))
    rs = bool(p["rolling_shutter"])
    n_poses, n_points, L = p["n_poses"], p["n_points"], p["track_len"]
    n_frames = n_poses - 1 if rs else n_poses
    model = {"rolling_shutter": rs, "interp": p.get("interp", "slerp"),
             "distortion": bool(p["distortion"])}
    focal = p.get("focal", 900.0)

    q_gt, c_gt = _trajectory(n_poses, min(2.0 * np.pi,
                                          0.02 * n_frames + 0.5))
    pts = rng.randn(n_points, 3)
    pts = 0.9 * pts / np.maximum(np.linalg.norm(pts, axis=1, keepdims=True),
                                 1.0)
    intr = np.zeros((1, 9))
    intr[:, 0] = intr[:, 1] = focal
    intr[:, 2], intr[:, 3] = W / 2.0, H / 2.0
    if model["distortion"]:
        intr[:, 4] = -0.15 + 0.02 * rng.randn(1)
        intr[:, 5] = 0.03 + 0.005 * rng.randn(1)
        intr[:, 6] = 1e-3 * rng.randn(1)
        intr[:, 7] = 1e-3 * rng.randn(1)

    first = rng.randint(0, max(n_frames - L + 1, 1), size=n_points)
    frame = np.minimum(first[:, None] + np.arange(L)[None, :], n_frames - 1)
    point = np.repeat(np.arange(n_points), L)
    pose_a = frame.reshape(-1)
    pose_b = pose_a + 1 if rs else pose_a

    # Ground-truth pass: under rolling shutter the measured row and the
    # row time agree, v = proj_v(t = v / H), by a damped fixed point.
    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)  # noqa: E731
    ia = torch.as_tensor(pose_a, device=dev)
    ib = torch.as_tensor(pose_b, device=dev)
    qa, ca, qb, cb = f64(q_gt)[ia], f64(c_gt)[ia], f64(q_gt)[ib], f64(c_gt)[ib]
    X = f64(pts)[torch.as_tensor(point, device=dev)]
    k = f64(intr[0])
    if rs:
        t = torch.full((X.shape[0],), 0.5, dtype=torch.float64, device=dev)
        for _ in range(40):
            v = geo.project(qa, ca, qb, cb, k, X, t, model)[:, 1]
            t = 0.5 * t + 0.5 * torch.clamp(v / H, 0.0, 1.0)
        v = geo.project(qa, ca, qb, cb, k, X, t, model)[:, 1]
        row_gap = (torch.abs(torch.clamp(v / H, 0.0, 1.0) - t) * H).cpu().numpy()
    else:
        t = torch.zeros(X.shape[0], dtype=torch.float64, device=dev)
        row_gap = np.zeros(X.shape[0])
    uv_clean = geo.project(qa, ca, qb, cb, k, X, t, model).cpu().numpy()
    depth = geo.camera_point(qa, ca, qb, cb, X, t, model)[:, 2].cpu().numpy()
    valid = ((depth > 0.2) & np.isfinite(uv_clean).all(axis=1)
             & (uv_clean[:, 0] >= 0) & (uv_clean[:, 0] < W)
             & (uv_clean[:, 1] >= 0) & (uv_clean[:, 1] < H)
             & (row_gap < 0.25))

    uv = uv_clean + rng.randn(*uv_clean.shape) * p["pixel_noise"]
    frac = p.get("outlier_fraction", 0.0)
    if frac > 0:
        out = rng.rand(uv.shape[0]) < frac
        uv[out, 0] = rng.rand(out.sum()) * W
        uv[out, 1] = rng.rand(out.sum()) * H
    t_meas = np.clip(uv[:, 1], 0, H) / H if rs else np.zeros(uv.shape[0])

    keep = np.nonzero(valid)[0]
    pad_to = p.get("pad_to", 256)
    total = keep.shape[0] + (-keep.shape[0] % pad_to)

    def pad(a, dtype):
        out = np.zeros((total,) + a.shape[1:], dtype=dtype)
        out[:keep.shape[0]] = a[keep]
        return out

    # The perturbed start: rotation ⊞ N(0, σ_rot), centre and points + N.
    P = n_poses
    dq = rng.randn(P, 3) * p["rot_sigma"]
    q0 = geo.boxplus(torch.as_tensor(q_gt), torch.as_tensor(dq)).numpy()
    c0 = c_gt + rng.randn(P, 3) * p["trans_sigma"]
    pts0 = pts + rng.randn(n_points, 3) * p["point_sigma"]
    q0[0], c0[0] = q_gt[0], c_gt[0]
    pose_free = np.ones(P)
    pose_free[0] = 0.0

    loss = p.get("loss", {"kind": "trivial", "scale": 1.0})
    return Scene(model=model, loss=dict(loss), image_size=(W, H),
                 pixel_noise=p["pixel_noise"],
                 uv=pad(uv, np.float64), t=pad(t_meas, np.float64),
                 pose_a=pad(pose_a, np.int32), pose_b=pad(pose_b, np.int32),
                 point=pad(point, np.int32),
                 mask=pad(np.ones(uv.shape[0]), np.float64),
                 pose_free=pose_free, intr=intr,
                 gt={"q": q_gt, "c": c_gt, "points": pts},
                 start={"q": q0, "c": c0, "points": pts0})


def frames_of(scene: Scene):
    """The scene as a video: for each frame, the ids of the tracks it sees
    and their pixels, in observation order."""
    m = scene.mask > 0
    pa, pid, uv = scene.pose_a[m], scene.point[m], scene.uv[m]
    order = np.argsort(pa, kind="stable")
    n_frames = scene.n_poses - 1 if scene.model["rolling_shutter"] \
        else scene.n_poses
    bounds = np.searchsorted(pa[order], np.arange(n_frames + 1))
    return [(pid[order[a:b]].astype(np.int64), uv[order[a:b]])
            for a, b in zip(bounds[:-1], bounds[1:])]
