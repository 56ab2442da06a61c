"""P3P minimal solver (Grunert) — batched and closed form.

Counterpart of ``rsba_tpu/solver/p3p.py``.  The classical Grunert (1841)
reduction: three unit rays fᵢ and three world points Xᵢ give a quartic
in a depth ratio; each admissible root yields camera-frame points sᵢfᵢ,
and a rigid alignment (Kabsch) recovers the pose.

Everything is batched over the hypothesis axis: the quartic is solved in
closed form (Ferrari, complex arithmetic, no iteration and no
data-dependent control flow) and the alignment is a batched 3×3 SVD, so a
RANSAC loop evaluates hundreds of hypotheses in one pass
(``solver/ransac.py``).  In float32 the roots are complex64; two Newton
steps (``_polish_roots``) take back what the closed form loses there.

The order of the four roots follows the branches of the complex square
and cube roots and may differ between libraries; callers gate and score
every root, so the set of valid solutions is what is defined.
"""
from __future__ import annotations

import torch

from ..geometry import quaternion as quat


# --- closed-form polynomial roots (batched, complex) -------------------------

def _complex_dtype(dtype):
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def _floor_magnitude(z: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """z with |z| < eps replaced by eps (a divisor that is never zero)."""
    return torch.where(torch.abs(z) < eps, torch.full_like(z, eps), z)


def solve_cubic_roots(B, C, D):
    """All three complex roots of m³ + B m² + C m + D (batched, Cardano)."""
    cdt = _complex_dtype(B.dtype)
    B, C, D = (x.to(cdt) for x in (B, C, D))
    p = C - B * B / 3.0
    q = 2.0 * B ** 3 / 27.0 - B * C / 3.0 + D
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3
    sq = torch.sqrt(disc)
    u3 = -q / 2.0 + sq
    # Avoid the u == 0 branch (p == 0, q >= 0) by switching the sqrt sign
    # where that gives the larger magnitude.
    u3b = -q / 2.0 - sq
    u3 = torch.where(torch.abs(u3) >= torch.abs(u3b), u3, u3b)
    u = _floor_magnitude(u3 ** (1.0 / 3.0))
    v = -p / (3.0 * u)
    w = complex(-0.5, 0.8660254037844386)               # exp(2πi/3)
    roots = [u * w ** k + v * w.conjugate() ** k - B / 3.0 for k in range(3)]
    return torch.stack(roots, dim=-1)


def solve_quartic_roots(c4, c3, c2, c1, c0):
    """All four complex roots of c4 z⁴ + … + c0 (batched, Ferrari).

    Degenerate leading coefficients (|c4| ≈ 0) return NaN roots, which the
    caller's realness and positivity gates discard.
    """
    cdt = _complex_dtype(c4.dtype)
    scale = torch.clamp(torch.stack(
        [torch.abs(c) for c in (c4, c3, c2, c1, c0)], dim=-1
    ).max(dim=-1).values, min=1e-30)
    bad = torch.abs(c4) < 1e-10 * scale
    c4s = torch.where(bad, 1.0, c4)
    b, c, d, e = (x / c4s for x in (c3, c2, c1, c0))
    # Depressed quartic z = y − b/4:  y⁴ + p y² + q y + r
    p = c - 3.0 * b * b / 8.0
    q = d - b * c / 2.0 + b ** 3 / 8.0
    r = e - b * d / 4.0 + b * b * c / 16.0 - 3.0 * b ** 4 / 256.0
    # Resolvent cubic 8m³ + 8pm² + (2p² − 8r)m − q² = 0.
    m_roots = solve_cubic_roots(p, (2.0 * p * p - 8.0 * r) / 8.0,
                                -q * q / 8.0)
    alpha2 = 2.0 * m_roots                               # α² candidates
    # The root giving the largest |α| keeps q/α well conditioned and
    # handles biquadratics, where one resolvent root is exactly 0
    # (argmax: the first maximum).
    pick = torch.argmax(torch.abs(alpha2), dim=-1, keepdim=True)
    alpha2 = torch.gather(alpha2, -1, pick)[..., 0]
    alpha = _floor_magnitude(torch.sqrt(alpha2))
    pc = p.to(cdt)
    qc = q.to(cdt)
    beta = (pc + alpha * alpha - qc / alpha) / 2.0
    gamma = (pc + alpha * alpha + qc / alpha) / 2.0
    # (y² + αy + β)(y² − αy + γ) = 0
    s1 = torch.sqrt(alpha * alpha - 4.0 * beta)
    s2 = torch.sqrt(alpha * alpha - 4.0 * gamma)
    roots = torch.stack([(-alpha + s1) / 2.0, (-alpha - s1) / 2.0,
                         (alpha + s2) / 2.0, (alpha - s2) / 2.0], dim=-1)
    roots = roots - (b / 4.0).to(cdt)[..., None]
    nan = torch.full_like(roots, complex(float("nan"), 0.0))
    return torch.where(bad[..., None], nan, roots)


def _polish_roots(c4, c3, c2, c1, c0, roots, iters: int = 2):
    """Newton-polish complex roots (cheap insurance in float32)."""
    cs = [x.to(roots.dtype)[..., None] for x in (c4, c3, c2, c1, c0)]
    for _ in range(iters):
        f = (((cs[0] * roots + cs[1]) * roots + cs[2]) * roots
             + cs[3]) * roots + cs[4]
        df = ((4.0 * cs[0] * roots + 3.0 * cs[1]) * roots
              + 2.0 * cs[2]) * roots + cs[3]
        roots = roots - f / _floor_magnitude(df)
    return roots


# --- Grunert P3P --------------------------------------------------------------

def _polymul(a, b):
    """Multiply coefficient lists (ascending powers of y)."""
    out = [0.0] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        for j, bj in enumerate(b):
            out[i + j] = out[i + j] + ai * bj
    return out


def p3p(rays: torch.Tensor, points: torch.Tensor):
    """Grunert P3P: camera pose(s) from 3 ray/point correspondences.

    Args:
      rays:   (..., 3, 3) unit bearing vectors in the camera frame.
      points: (..., 3, 3) corresponding world points.

    Returns:
      q: (..., 4, 4) up to four world→camera quaternions (wxyz),
      c: (..., 4, 3) camera centers (world),
      valid: (..., 4) admissibility of each solution (real positive
        depths, non-degenerate geometry).

    Convention as geometry.camera: ``X_cam = R(q)(X − c)``; the recovered
    pose satisfies ``sᵢ · rayᵢ = R(q)(Xᵢ − c)``.
    """
    f1, f2, f3 = rays[..., 0, :], rays[..., 1, :], rays[..., 2, :]
    X1, X2, X3 = points[..., 0, :], points[..., 1, :], points[..., 2, :]

    a2 = torch.sum((X2 - X3) ** 2, dim=-1)
    b2 = torch.sum((X1 - X3) ** 2, dim=-1)
    c2 = torch.sum((X1 - X2) ** 2, dim=-1)
    p = 2.0 * torch.sum(f2 * f3, dim=-1)
    qq = 2.0 * torch.sum(f1 * f3, dim=-1)
    r = 2.0 * torch.sum(f1 * f2, dim=-1)

    b2s = torch.where(b2 > 1e-30, b2, 1.0)
    A = a2 / b2s
    B = c2 / b2s
    one = torch.ones_like(A)
    # x = s2/s1 = N(y)/D(y); quartic Q(y) = D²(1 − B·M) + N² − r·N·D.
    N = [1.0 + (A - B), -(A - B) * qq, (A - B) - 1.0]
    D = [r, -p]
    M = [one, -qq, one]
    D2 = _polymul(D, D)
    one_minus_BM = [1.0 - B * M[0], -B * M[1], -B * M[2]]
    Q = [torch.zeros_like(A)] * 5
    for poly in (_polymul(D2, one_minus_BM), _polymul(N, N),
                 _polymul([-r * n for n in N], D)):
        for i, v in enumerate(poly):
            Q[i] = Q[i] + v

    roots = solve_quartic_roots(Q[4], Q[3], Q[2], Q[1], Q[0])
    roots = _polish_roots(Q[4], Q[3], Q[2], Q[1], Q[0], roots)
    y = roots.real                                         # (..., 4)
    im = torch.abs(roots.imag)
    real_ok = im <= 1e-4 * (1.0 + torch.abs(y))

    # Depths from each real root.
    Ny = (N[0][..., None] + N[1][..., None] * y + N[2][..., None] * y * y)
    Dy = D[0][..., None] + D[1][..., None] * y
    Dy = torch.where(torch.abs(Dy) < 1e-12, 1e-12, Dy)
    x = Ny / Dy
    My = (M[0][..., None] + M[1][..., None] * y + M[2][..., None] * y * y)
    s1 = torch.sqrt(b2[..., None] / torch.where(My > 1e-12, My, 1.0))
    s2 = x * s1
    s3 = y * s1
    valid = (real_ok & (My > 1e-12) & (y > 0) & (x > 0)
             & torch.isfinite(y) & (b2[..., None] > 1e-30))

    # Camera-frame points Yᵢ = sᵢ fᵢ → rigid alignment (Kabsch) world→cam.
    Y = torch.stack([s1[..., None] * f1[..., None, :],
                     s2[..., None] * f2[..., None, :],
                     s3[..., None] * f3[..., None, :]], dim=-2)
    Xw = points[..., None, :, :].expand_as(Y)
    Xbar = torch.mean(Xw, dim=-2, keepdim=True)
    Ybar = torch.mean(Y, dim=-2, keepdim=True)
    H = (Xw - Xbar).transpose(-1, -2) @ (Y - Ybar)
    # The SVD does not take non-finite input on every backend; the
    # hypotheses that carry it are invalid already.
    h_ok = torch.isfinite(H).all(dim=(-1, -2))
    H = torch.where(h_ok[..., None, None], H,
                    torch.eye(3, dtype=H.dtype, device=H.device))
    U, _, Vt = torch.linalg.svd(H)
    V, Ut = Vt.transpose(-1, -2), U.transpose(-1, -2)
    det = torch.linalg.det(V @ Ut)
    S = torch.stack([torch.ones_like(det), torch.ones_like(det), det],
                    dim=-1)
    R = (V * S[..., None, :]) @ Ut
    q = quat.from_matrix(R)
    # Y = R X + t → c = −Rᵀ t = Xbar − Rᵀ Ybar.
    cpos = Xbar[..., 0, :] - quat.rotate_inverse(q, Ybar[..., 0, :])
    valid = valid & h_ok & torch.all(torch.isfinite(q), dim=-1) \
        & torch.all(torch.isfinite(cpos), dim=-1)
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=q.dtype,
                         device=q.device)
    q = torch.where(valid[..., None], torch.nan_to_num(q, 0.0, 0.0, 0.0),
                    ident)
    cpos = torch.where(valid[..., None],
                       torch.nan_to_num(cpos, 0.0, 0.0, 0.0), 0.0)
    return q, cpos, valid
