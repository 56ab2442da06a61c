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


def boxplus(q: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """q ⊞ δ = normalize(q ⊗ exp(δ)) (right-multiplied local perturbation)."""
    return normalize(multiply(q, from_axis_angle(delta)))


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
