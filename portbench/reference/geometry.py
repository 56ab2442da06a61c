"""Plain rolling-shutter camera geometry in PyTorch, written for the
benchmark from the model's definition and independent of the program.

Conventions (those of the upstream project's problem configs):

* pose (q, c): unit quaternion q = [w, x, y, z], world→camera rotation
  R(q), camera centre c; ``X_cam = R(q) (X − c)``;
* intrinsics [fx, fy, cx, cy, k1, k2, p1, p2, k3]; radial-tangential
  distortion in OpenCV's order;
* rolling shutter: the pose at row time t ∈ [0, 1] interpolates the two
  keyframe poses of the observation: rotation by SLERP
  ``qa ⊗ exp(t · log(qa⁻¹ ⊗ qb))`` or by normalised linear interpolation
  on qa's hemisphere ("nlerp"), centre linearly;
* the robust loss is Huber with scale a on the squared norm s = ‖r‖²:
  ρ(s) = s for s ≤ a², else 2a√s − a²; the cost is ½ Σ ρ.

Every function works on any device and dtype; the benchmark's checks
call it in float64.
"""
from __future__ import annotations

import torch


def qmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], dim=-1)


def qconj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def qnormalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R(q) v."""
    w, u = q[..., :1], q[..., 1:]
    uv = torch.linalg.cross(u, v, dim=-1)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv, dim=-1))


def qexp(d: torch.Tensor) -> torch.Tensor:
    """Rotation vector → unit quaternion, with a Taylor branch near 0 that
    keeps forward-mode derivatives finite."""
    th2 = torch.sum(d * d, dim=-1, keepdim=True)
    small = th2 < 1e-8
    th = torch.sqrt(torch.where(small, torch.ones_like(th2), th2))
    k = torch.where(small, 0.5 - th2 / 48.0, torch.sin(0.5 * th) / th)
    w = torch.where(small, 1.0 - th2 / 8.0, torch.cos(0.5 * th))
    return torch.cat([w, k * d], dim=-1)


def qlog(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion → rotation vector (angle in [0, π])."""
    sign = torch.where(q[..., :1] < 0, -1.0, 1.0).to(q.dtype)
    w, u = sign * q[..., :1], sign * q[..., 1:]
    s = torch.linalg.vector_norm(u, dim=-1, keepdim=True)
    small = s < 1e-8
    k = torch.where(small, 2.0 / torch.where(small, w, torch.ones_like(w)),
                    2.0 * torch.atan2(s, w) / torch.where(small, 1.0, s))
    return k * u


def boxplus(q: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """q ⊞ d = normalize(q ⊗ exp(d)): a right-multiplied local step."""
    return qnormalize(qmul(q, qexp(d)))


def interpolate(qa, ca, qb, cb, t, interp: str):
    """Pose at row time t between keyframes a and b."""
    tt = t[..., None]
    if interp == "slerp":
        q = qmul(qa, qexp(tt * qlog(qmul(qconj(qa), qb))))
    elif interp == "nlerp":
        qb = torch.where(torch.sum(qa * qb, dim=-1, keepdim=True) < 0,
                         -qb, qb)
        q = qnormalize((1.0 - tt) * qa + tt * qb)
    else:
        raise ValueError(f"unknown interpolation {interp!r}")
    return q, (1.0 - tt) * ca + tt * cb


def distort(xy: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    x, y = xy[..., 0], xy[..., 1]
    k1, k2, p1, p2, k3 = k.unbind(-1)
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    return torch.stack([x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x),
                        y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y],
                       dim=-1)


def camera_point(qa, ca, qb, cb, X, t, model: dict) -> torch.Tensor:
    """The world point X in the frame of the camera at row time t."""
    if model["rolling_shutter"]:
        q, c = interpolate(qa, ca, qb, cb, t, model["interp"])
    else:
        q, c = qa, ca
    return rotate(q, X - c)


def project(qa, ca, qb, cb, intr, X, t, model: dict) -> torch.Tensor:
    """Pixel of X seen at row time t (global shutter: pose a, t unused)."""
    xc = camera_point(qa, ca, qb, cb, X, t, model)
    xy = xc[..., :2] / xc[..., 2:3]
    if model["distortion"]:
        xy = distort(xy, intr[..., 4:9])
    return intr[..., 0:2] * xy + intr[..., 2:4]


def huber(s: torch.Tensor, a: float):
    """(ρ(s), ρ'(s)) of the Huber loss on the squared norm s."""
    out = s > a * a
    r = torch.sqrt(torch.clamp(s, min=a * a))
    return (torch.where(out, 2.0 * a * r - a * a, s),
            torch.where(out, a / r, torch.ones_like(s)))
