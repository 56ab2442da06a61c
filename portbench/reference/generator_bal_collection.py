"""The benchmark's generator of a BAL-style photo collection: the scene,
cameras and projection of ``generator_bal.py`` (global shutter, every
camera with its own focal length, k1 and k2 optimised, pose 0 held as
the gauge), with each point's track drawn as in an unordered collection
of photos, not a video.

A point's track: a centre camera drawn uniformly from the ring of
``n_poses`` cameras, then k cameras drawn without replacement, uniformly
from the 2h + 1 cameras around the centre on the ring (wrapping round),
with h = ``track_half_window``; k = ``track_min`` + a geometric draw (the
failures before the first success, success probability
``track_geometric_p``), at most ``track_max``.  A point's observations
are listed by camera, so that the tracks are not runs of consecutive
poses and the camera graph is a photo collection's.  Observations that
fall behind a camera or outside its image are dropped, as
``generator_bal`` drops them.

Every random number comes from ``np.random.RandomState(seed)``, in the
order: the points, the cameras' intrinsics, the tracks (centres, lengths,
then the choices in blocks of points), the pixel noise, the perturbed
start (rotation, centre, points, focal, k1, k2).  It imports nothing of
the program.  ``make_scene`` returns a ``generator_bal.Scene`` of host
arrays (float64 and int32); the ground-truth pass runs in float64 on the
device it is given.
"""
from __future__ import annotations

import numpy as np
import torch

from . import generator
from . import geometry as geo
from .generator_bal import Scene

#: points whose choices are drawn at once (the keys of a block are
#: (block, 2h + 1) doubles)
TRACK_BLOCK = 1 << 16


def tracks(rng: np.random.RandomState, p: dict):
    """(camera (n_obs,), point (n_obs,)) of every point's track, point by
    point and within a point by camera."""
    P, M = p["n_poses"], p["n_points"]
    h = p["track_half_window"]
    width = 2 * h + 1
    if width > P:
        raise ValueError("the window around a centre holds more cameras "
                         "than the ring")
    kmax = min(p["track_max"], width)
    centre = rng.randint(0, P, size=M)
    k = np.minimum(p["track_min"] - 1 + rng.geometric(
        p["track_geometric_p"], size=M), kmax)
    cams = []
    for lo in range(0, M, TRACK_BLOCK):
        hi = min(lo + TRACK_BLOCK, M)
        pick = np.argsort(rng.rand(hi - lo, width), axis=1)[:, :kmax]
        keep = np.arange(kmax)[None, :] < k[lo:hi, None]
        cam = np.where(keep, (centre[lo:hi, None] + pick - h) % P, P)
        cams.append(np.sort(cam, axis=1))
    cam = np.concatenate(cams)
    keep = cam < P
    point = np.broadcast_to(np.arange(M)[:, None], cam.shape)
    return cam[keep], point[keep]


def make_scene(p: dict, seed: int, device="cpu") -> Scene:
    """One problem from the generator parameters ``p`` (a configuration's
    ``generator`` group: ``generator_bal``'s keys without ``track_len``,
    and the ``track_*`` keys above) and ``seed`` (0 ≤ seed < 2**32)."""
    if p.get("rolling_shutter") or not (p.get("per_camera_intrinsics")
                                        and p.get("optimize_intrinsics")):
        raise ValueError("the photo-collection generator makes "
                         "global-shutter problems with per-camera, "
                         "optimised intrinsics")
    dev = torch.device(device)
    rng = np.random.RandomState(seed)
    W, H = p.get("image_size", (1024, 768))
    P, n_points = p["n_poses"], p["n_points"]
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

    pose, point = tracks(rng, p)

    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)  # noqa: E731
    ia = torch.as_tensor(pose, device=dev)
    q, c = f64(q_gt)[ia], f64(c_gt)[ia]
    X = f64(pts)[torch.as_tensor(point, device=dev)]
    t = torch.zeros(X.shape[0], dtype=torch.float64, device=dev)
    uv_clean = geo.project(q, c, q, c, f64(intr)[ia], X, t,
                           model).cpu().numpy()
    depth = geo.camera_point(q, c, q, c, X, t, model)[:, 2].cpu().numpy()
    del q, c, X, t
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

    # The perturbed start, as generator_bal draws it.
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
