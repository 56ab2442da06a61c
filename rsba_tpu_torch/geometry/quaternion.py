"""Quaternion and rotation utilities on torch tensors.

Counterpart of ``rsba_tpu/geometry/quaternion.py``; the conventions are
the same:

* Hamilton quaternions stored ``[w, x, y, z]`` (scalar first), unit norm;
  ``q`` is the world→camera rotation ``R(q)``.
* Angle-axis vectors ``aa`` satisfy ``R(aa) = exp([aa]_x)``.
* Small-angle Taylor branches are picked with ``torch.where`` on both
  sides, so forward-mode differentiation (``torch.func.jacfwd``) never
  sees NaN in the branch that is taken.
"""
from __future__ import annotations

import torch

# Small-angle threshold: below this, use Taylor branches.
_EPS = 1e-8


def _t(t, like: torch.Tensor) -> torch.Tensor:
    """Shutter time(s) as a tensor with a trailing unit axis."""
    if not isinstance(t, torch.Tensor):
        t = torch.as_tensor(t, dtype=like.dtype, device=like.device)
    return t[..., None]


def normalize(q: torch.Tensor) -> torch.Tensor:
    """Normalize quaternion(s) to unit norm along the last axis."""
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b, wxyz layout, broadcasting over leading dims."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R(q)·v with ``v' = v + 2·w·(u×v) + 2·u×(u×v)``, ``u = q.xyz``."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def rotate_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by the inverse rotation: R(q)ᵀ·v."""
    return rotate(conjugate(q), v)


def to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion → 3×3 rotation matrix (R(q)·v == rotate(q, v))."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def from_matrix(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix → unit quaternion (wxyz), batched and branch-free.

    Shepperd's method: all four candidate quaternions (scaled by 4w², 4x²,
    4y², 4z²) are built and the one with the largest pivot is selected, so
    180° rotations, where the trace formula alone loses precision, are
    safe.  Inverse of :func:`to_matrix` up to the double cover.
    """
    m = R
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    t0 = 1.0 + m00 + m11 + m22    # 4w²
    t1 = 1.0 + m00 - m11 - m22    # 4x²
    t2 = 1.0 - m00 + m11 - m22    # 4y²
    t3 = 1.0 - m00 - m11 + m22    # 4z²
    a = m[..., 2, 1] - m[..., 1, 2]
    b = m[..., 0, 2] - m[..., 2, 0]
    c = m[..., 1, 0] - m[..., 0, 1]
    d = m[..., 0, 1] + m[..., 1, 0]
    e = m[..., 0, 2] + m[..., 2, 0]
    f = m[..., 1, 2] + m[..., 2, 1]
    cands = torch.stack([
        torch.stack([t0, a, b, c], dim=-1),
        torch.stack([a, t1, d, e], dim=-1),
        torch.stack([b, d, t2, f], dim=-1),
        torch.stack([c, e, f, t3], dim=-1)], dim=-2)         # (…, 4, 4)
    # argmax returns the first maximum, as the reference's does.
    best = torch.argmax(torch.stack([t0, t1, t2, t3], dim=-1), dim=-1)
    q = torch.gather(cands, -2,
                     best[..., None, None].expand(best.shape + (1, 4)))
    return normalize(q[..., 0, :])


def from_axis_angle(aa: torch.Tensor) -> torch.Tensor:
    """Angle-axis (…, 3) → unit quaternion (…, 4). Safe at ‖aa‖ → 0."""
    theta_sq = torch.sum(aa * aa, dim=-1, keepdim=True)
    theta = torch.sqrt(theta_sq + _EPS * _EPS)
    half = 0.5 * theta
    small = theta_sq < _EPS
    k = torch.where(small, 0.5 - theta_sq / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(half))
    return torch.cat([w, k * aa], dim=-1)


def to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion → angle-axis (…, 3), angle in [0, π]."""
    w = q[..., :1]
    u = q[..., 1:]
    sin_half = torch.linalg.vector_norm(u, dim=-1, keepdim=True)
    sign = torch.where(w < 0, -1.0, 1.0).to(q.dtype)
    w, u = sign * w, sign * u
    half = torch.atan2(sin_half, w)
    small = sin_half < _EPS
    k = torch.where(small, 2.0,
                    2.0 * half / torch.where(small, 1.0, sin_half))
    return k * u


def exp_tangent(delta: torch.Tensor) -> torch.Tensor:
    """SO(3) exponential of a tangent vector → quaternion (the same map
    as :func:`from_axis_angle`, named for its manifold role)."""
    return from_axis_angle(delta)


def boxplus(q: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """q ⊞ δ = normalize(q ⊗ exp(δ)) (right-multiplied local perturbation)."""
    return normalize(multiply(q, exp_tangent(delta)))


def log(q: torch.Tensor) -> torch.Tensor:
    """SO(3) logarithm: quaternion → tangent (…, 3) (== to_axis_angle)."""
    return to_axis_angle(q)


def relative(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """qa⁻¹ ⊗ qb — the rotation taking frame a to frame b."""
    return multiply(conjugate(qa), qb)


def slerp(qa: torch.Tensor, qb: torch.Tensor, t) -> torch.Tensor:
    """``qa ⊗ exp(t·log(qa⁻¹ ⊗ qb))``: SLERP on the shortest arc, smooth
    through qa == qb."""
    t = _t(t, qa)
    d = to_axis_angle(relative(qa, qb))
    return multiply(qa, from_axis_angle(t * d))


def nlerp(qa: torch.Tensor, qb: torch.Tensor, t) -> torch.Tensor:
    """Normalized linear interpolation on qa's hemisphere."""
    t = _t(t, qa)
    dot = torch.sum(qa * qb, dim=-1, keepdim=True)
    qb = torch.where(dot < 0, -qb, qb)
    return normalize((1.0 - t) * qa + t * qb)


def lerp_axis_angle(aa_a: torch.Tensor, aa_b: torch.Tensor,
                    t) -> torch.Tensor:
    """Lerp of global angle-axis vectors, returned as a quaternion."""
    t = _t(t, aa_a)
    return from_axis_angle((1.0 - t) * aa_a + t * aa_b)
