"""The benchmark's frozen copy of the synthetic generator's per-camera
branch: a BAL-style global-shutter problem whose every camera has its own
intrinsics, with focal length, k1 and k2 optimised.

It draws every random number from ``np.random.RandomState(seed)`` in the
order of the program's ``problem/synthetic.py::make_ba_problem`` with
``per_camera_intrinsics`` and ``optimize_intrinsics`` set, and projects
with this package's own geometry, so that in float64 it gives the
program's ``CONFIGS["gs_bal"]`` problems; the tests hold it to that.  It
imports nothing of the program.

``make_scene`` returns a ``Scene`` (host arrays, float64 and int32) with
the camera of each observation in ``intr_idx`` (its pose: one camera a
frame), the intrinsics (K, 9) of the ground truth in ``intr`` and in
``gt["intr"]``, and the perturbed start's in ``start["intr"]``: the
focal lengths moved by N(0, 1% of the focal), k1 and k2 by N(0, 0.01).
The poses in ``fixed_poses`` (pose 0 in the program's problems) are held
constant, the gauge, and start at the ground truth; their cameras'
intrinsics are free and start perturbed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import generator
from . import geometry as geo


@dataclasses.dataclass
class Scene(generator.Scene):
    intr_idx: np.ndarray   # (N,) int32, the camera of each observation


def make_scene(p: dict, seed: int, device="cpu") -> Scene:
    """One problem from the generator parameters ``p`` (a configuration's
    ``generator`` group, ``per_camera_intrinsics`` and
    ``optimize_intrinsics`` set) and ``seed`` (0 ≤ seed < 2**32)."""
    if p.get("rolling_shutter") or not (p.get("per_camera_intrinsics")
                                        and p.get("optimize_intrinsics")):
        raise ValueError("the BAL-style generator makes global-shutter "
                         "problems with per-camera, optimised intrinsics")
    dev = torch.device(device)
    rng = np.random.RandomState(seed)
    W, H = p.get("image_size", (1024, 768))
    P, n_points, L = p["n_poses"], p["n_points"], p["track_len"]
    model = {"rolling_shutter": False, "interp": "slerp",
             "distortion": bool(p["distortion"])}
    focal = p.get("focal", 900.0)

    q_gt, c_gt = generator._trajectory(P, min(2.0 * np.pi, 0.02 * P + 0.5))
    pts = rng.randn(n_points, 3)
    pts = pts / np.maximum(np.linalg.norm(pts, axis=1, keepdims=True), 1.0)
    pts *= 0.9
    intr = np.zeros((P, 9))
    intr[:, 0] = intr[:, 1] = focal * (1.0 + p["focal_spread"] * rng.randn(P))
    intr[:, 2], intr[:, 3] = W / 2.0, H / 2.0
    if model["distortion"]:
        intr[:, 4] = -0.15 + 0.02 * rng.randn(P)
        intr[:, 5] = 0.03 + 0.005 * rng.randn(P)
        intr[:, 6] = 1e-3 * rng.randn(P)
        intr[:, 7] = 1e-3 * rng.randn(P)

    first = rng.randint(0, max(P - L + 1, 1), size=n_points)
    pose = np.minimum(first[:, None] + np.arange(L)[None, :],
                      P - 1).reshape(-1)
    point = np.repeat(np.arange(n_points), L)

    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)  # noqa: E731
    ia = torch.as_tensor(pose, device=dev)
    q, c = f64(q_gt)[ia], f64(c_gt)[ia]
    X = f64(pts)[torch.as_tensor(point, device=dev)]
    t = torch.zeros(X.shape[0], dtype=torch.float64, device=dev)
    uv_clean = geo.project(q, c, q, c, f64(intr)[ia], X, t,
                           model).cpu().numpy()
    depth = geo.camera_point(q, c, q, c, X, t, model)[:, 2].cpu().numpy()
    valid = ((depth > 0.2) & np.isfinite(uv_clean).all(axis=1)
             & (uv_clean[:, 0] >= 0) & (uv_clean[:, 0] < W)
             & (uv_clean[:, 1] >= 0) & (uv_clean[:, 1] < H))

    uv = uv_clean + rng.randn(*uv_clean.shape) * p["pixel_noise"]
    keep = np.nonzero(valid)[0]
    pad_to = p.get("pad_to", 256)
    total = keep.shape[0] + (-keep.shape[0] % pad_to)

    def pad(a, dtype):
        out = np.zeros((total,) + a.shape[1:], dtype=dtype)
        out[:keep.shape[0]] = a[keep]
        return out

    # The perturbed start: rotation ⊞ N(0, σ_rot), centre and points + N,
    # then the focal (fx and fy alike), k1 and k2 of every camera.
    dq = rng.randn(P, 3) * p["rot_sigma"]
    q0 = geo.boxplus(torch.as_tensor(q_gt), torch.as_tensor(dq)).numpy()
    c0 = c_gt + rng.randn(P, 3) * p["trans_sigma"]
    pts0 = pts + rng.randn(n_points, 3) * p["point_sigma"]
    d = np.zeros((P, 9))
    d[:, 0] = d[:, 1] = rng.randn(P) * (p["intr_f_sigma"] * focal)
    d[:, 4] = rng.randn(P) * p["intr_k_sigma"]
    d[:, 5] = rng.randn(P) * p["intr_k_sigma"]
    fixed = list(p["fixed_poses"])
    q0[fixed], c0[fixed] = q_gt[fixed], c_gt[fixed]
    pose_free = np.ones(P)
    pose_free[fixed] = 0.0

    pose_obs = pad(pose, np.int32)
    return Scene(model=model, loss={"kind": "trivial", "scale": 1.0},
                 image_size=(W, H), pixel_noise=p["pixel_noise"],
                 uv=pad(uv, np.float64), t=np.zeros(total),
                 pose_a=pose_obs, pose_b=pose_obs.copy(),
                 point=pad(point, np.int32),
                 mask=pad(np.ones(uv.shape[0]), np.float64),
                 pose_free=pose_free, intr=intr,
                 gt={"q": q_gt, "c": c_gt, "intr": intr, "points": pts},
                 start={"q": q0, "c": c0, "intr": intr + d, "points": pts0},
                 intr_idx=pose_obs.copy())
