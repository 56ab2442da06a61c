"""Banded Schur pieces on the window layout.

Counterpart of ``rsba_tpu/solver/banded.py``.  For video bundle
adjustment, feature tracks span bounded pose windows, so the reduced
camera system S = B_λ − E C_λ⁻¹ Eᵀ is block banded along the trajectory
(bandwidth = window span W) and is stored as a (P, W, 6, 6) upper band.

This module holds the plain residual path (residuals, cost, pairwise cost
decrease, error statistics), the plain evaluator and assembler that the
fused kernel's plain version is built on (``evaluate`` uses
``torch.func.jacfwd`` + ``vmap``), and the band operators PCG needs.

Internal parameter layout here: ``Params`` with ``points`` in the padded
(NR·G, 3) window order.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import CameraModel, Loss, camera
from ..geometry import quaternion as quat
from ..problem.types import POSE_DOF, Params, Problem
from .window import WindowPlan


class WEvaluation(NamedTuple):
    """Triggs-corrected residuals + block Jacobians in window layout."""
    r: torch.Tensor      # (NR, G, L, 2)
    cost: torch.Tensor   # scalar
    J_pa: torch.Tensor   # (NR, G, L, 2, 6)
    J_pb: torch.Tensor   # (NR, G, L, 2, 6)
    J_pt: torch.Tensor   # (NR, G, L, 2, 3)


class BandAssembly(NamedTuple):
    """Banded normal equations; the Jacobians are consumed."""
    g_cam: torch.Tensor   # (P, 6)
    g_pt: torch.Tensor    # (NR, G, 3)
    C: torch.Tensor       # (NR, G, 3, 3)
    F: torch.Tensor       # (NR, G, W, 6, 3)
    B_band: torch.Tensor  # (P, W, 6, 6) upper band of B (d = col − row)


def _slot_pose_data(params: Params, plan: WindowPlan):
    """Per-slot (qa, ca, qb, cb), one window select per side."""
    win = torch.cat([plan.pose_windows(params.q),
                     plan.pose_windows(params.c)], dim=-1)
    sa = plan.select_a(win)               # (NR, G, L, 7)
    sb = plan.select_b(win)
    return sa[..., :4], sa[..., 4:], sb[..., :4], sb[..., 4:]


def _points_w(params: Params, plan: WindowPlan) -> torch.Tensor:
    """Internal padded points (NR, G, 3)."""
    return params.points.reshape(plan.NR, plan.G, 3)


def to_internal(params: Params, plan: WindowPlan) -> Params:
    """External (M, 3) point order → padded window order (NR·G, 3)."""
    return params.replace(points=plan.gather_points(params.points)
                          .reshape(-1, 3))


def to_external(params: Params, plan: WindowPlan) -> Params:
    """Padded window order → external (M, 3) point order."""
    pts_w = params.points.reshape(plan.NR, plan.G, 3)
    return params.replace(points=plan.scatter_points(pts_w))


def residuals_raw(params: Params, plan: WindowPlan, problem: Problem
                  ) -> torch.Tensor:
    """(NR, G, L, 2) uncorrected reprojection residuals (unmasked)."""
    qa, ca, qb, cb = _slot_pose_data(params, plan)
    X = _points_w(params, plan)[:, :, None, :]
    proj = camera.project(qa, ca, qb, cb, params.intr[0], X, plan.t,
                          problem.model)
    return proj - plan.uv


def _rho(r: torch.Tensor, loss: Loss) -> torch.Tensor:
    rho, _, _ = loss.evaluate(torch.sum(r * r, dim=-1))
    return rho


def cost_only(plan: WindowPlan, problem: Problem, params: Params):
    # Selection, not multiplication: padded slots gather a sentinel point
    # that can project degenerately (0/0 → NaN).
    rho = _rho(residuals_raw(params, plan, problem), problem.loss)
    return 0.5 * torch.sum(torch.where(plan.mask > 0, rho, 0.0))


def cost_decrease(plan: WindowPlan, problem: Problem, p_old: Params,
                  p_new: Params):
    """Pairwise-differenced robust cost decrease (f32-safe)."""
    rho_old = _rho(residuals_raw(p_old, plan, problem), problem.loss)
    rho_new = _rho(residuals_raw(p_new, plan, problem), problem.loss)
    return 0.5 * torch.sum(torch.where(plan.mask > 0, rho_old - rho_new,
                                       0.0))


def error_stats(plan: WindowPlan, problem: Problem, params: Params,
                inlier_threshold: float):
    """(Σ‖r‖², n_valid, Σ_inlier ‖r‖², n_inlier) over valid slots."""
    r = residuals_raw(params, plan, problem)
    m = plan.mask
    s = torch.where(m > 0, torch.sum(r * r, dim=-1), 0.0)
    inl = m * (s <= inlier_threshold * inlier_threshold)
    return torch.sum(s), torch.sum(m), torch.sum(inl * s), torch.sum(inl)


# --- plain evaluator + assembler ---------------------------------------------

def evaluate_slots(qa, ca, qb, cb, intr, X, uv, t, mask, pf_a, pf_b, ptf,
                   model: CameraModel, loss: Loss) -> WEvaluation:
    """Residuals + tangent Jacobians for every slot of an (NR, G, L) grid.

    qa/qb (NR, G, L, 4), ca/cb (NR, G, L, 3), intr (9,), X (NR, G, 3),
    uv (NR, G, L, 2), t/mask/pf_a/pf_b (NR, G, L), ptf (NR, G).

    Masking: only slots with mask > 0 are evaluated, and the rest get
    zero r/J (padded slots can project to NaN); pose/point free masks
    zero J columns (constant blocks).
    """
    grid = tuple(t.shape)
    dtype = t.dtype

    def f(d_pa, d_pb, d_pt, qa, ca, qb, cb, intr, X, uv, t):
        qa2 = quat.boxplus(qa, d_pa[:3])
        qb2 = quat.boxplus(qb, d_pb[:3])
        r = camera.project(qa2, ca + d_pa[3:], qb2, cb + d_pb[3:], intr,
                           X + d_pt, t, model) - uv
        return r, r

    zeros = (torch.zeros(POSE_DOF, dtype=dtype, device=t.device),
             torch.zeros(POSE_DOF, dtype=dtype, device=t.device),
             torch.zeros(3, dtype=dtype, device=t.device))

    def one(qa, ca, qb, cb, intr, X, uv, t):
        J, r = torch.func.jacfwd(f, argnums=(0, 1, 2), has_aux=True)(
            *zeros, qa, ca, qb, cb, intr, X, uv, t)
        return r, torch.cat(J, dim=-1)

    S = t.numel()
    idx = torch.nonzero(mask.reshape(S) > 0).squeeze(1)   # valid slots
    flat = lambda a: a.reshape((S,) + tuple(a.shape[3:]))[idx]  # noqa: E731
    Xs = X[:, :, None, :].expand(grid + (3,))
    if idx.numel() > 0:
        r, J = torch.func.vmap(one, in_dims=(0, 0, 0, 0, None, 0, 0, 0))(
            flat(qa), flat(ca), flat(qb), flat(cb), intr, flat(Xs),
            flat(uv), flat(t))                      # (V, 2), (V, 2, 15)
    else:   # padding rows only (a block of a sharded solve)
        r, J = t.new_zeros((0, 2)), t.new_zeros((0, 2, 2 * POSE_DOF + 3))

    r, J, rho = loss.correct(r, J)
    cost = 0.5 * torch.sum(rho)
    rt = r.new_zeros((S, 2)).index_copy_(0, idx, r)
    Jt = J.new_zeros((S, 2, J.shape[-1])).index_copy_(0, idx, J)
    J_pa, J_pb, J_pt = torch.split(Jt, [POSE_DOF, POSE_DOF, 3], dim=-1)
    J_pa = J_pa.reshape(grid + (2, POSE_DOF)) * pf_a[..., None, None]
    J_pb = J_pb.reshape(grid + (2, POSE_DOF)) * pf_b[..., None, None]
    J_pt = J_pt.reshape(grid + (2, 3)) * ptf[:, :, None, None, None]
    return WEvaluation(r=rt.reshape(grid + (2,)), cost=cost, J_pa=J_pa,
                       J_pb=J_pb, J_pt=J_pt)


def evaluate(params: Params, plan: WindowPlan, problem: Problem
             ) -> WEvaluation:
    """Residuals + tangent-space Jacobians for every slot (jacfwd+vmap)."""
    qa, ca, qb, cb = _slot_pose_data(params, plan)
    pf_w = plan.pose_windows(problem.pose_free)      # (NR, W)
    return evaluate_slots(
        qa, ca, qb, cb, params.intr[0], _points_w(params, plan), plan.uv,
        plan.t, plan.mask, plan.select_a(pf_w), plan.select_b(pf_w),
        plan.gather_point_scalar(problem.point_free), problem.model,
        problem.loss)


def _window_sum(v: torch.Tensor, offs: torch.Tensor, W: int,
                per_point: bool = False) -> torch.Tensor:
    """Sum slot values (NR, G, L, ...) into their W-window slot:
    → (NR, W, ...), or (NR, G, W, ...) with ``per_point``."""
    NR, G, L = offs.shape
    rest = tuple(v.shape[3:])
    if per_point:
        base = torch.arange(NR * G, device=offs.device).reshape(NR, G, 1)
        n_out = NR * G * W
    else:
        base = torch.arange(NR, device=offs.device).reshape(NR, 1, 1)
        n_out = NR * W
    idx = (base * W + offs).reshape(-1)
    out = v.new_zeros((n_out,) + rest)
    out.index_add_(0, idx, v.reshape((-1,) + rest))
    return out.reshape(((NR, G, W) if per_point else (NR, W)) + rest)


def assemble_windows(ev: WEvaluation, offs_a: torch.Tensor,
                     offs_b: torch.Tensor, rs_ab: torch.Tensor,
                     mask: torch.Tensor, W: int) -> dict:
    """One pass over window-layout Jacobians → per-row window sums (not
    yet folded into poses) and per-point blocks:

    gw (NR, W, 6), b0/b1 (NR, W, 6, 6) band d=0/d=1 windows,
    g_pt (NR, G, 3), C (NR, G, 3, 3), F (NR, G, W, 6, 3).
    """
    m = mask[..., None]
    r, Ja, Jb, Jp = ev.r, ev.J_pa, ev.J_pb, ev.J_pt
    ta = torch.einsum("sglr,sglra->sgla", r, Ja)
    tb = torch.einsum("sglr,sglra->sgla", r, Jb)
    gw = (_window_sum(ta * m, offs_a, W) + _window_sum(tb * m, offs_b, W))
    g_pt = torch.einsum("sglr,sglrp->sgp", r, Jp)
    C = torch.einsum("sglrp,sglrq->sgpq", Jp, Jp)
    m5 = m[..., None]
    fa = torch.einsum("sglra,sglrp->sglap", Ja, Jp) * m5
    fb = torch.einsum("sglra,sglrp->sglap", Jb, Jp) * m5
    F = (_window_sum(fa, offs_a, W, per_point=True)
         + _window_sum(fb, offs_b, W, per_point=True))
    aa = torch.einsum("sglra,sglrb->sglab", Ja, Ja) * m5
    bb = torch.einsum("sglra,sglrb->sglab", Jb, Jb) * m5
    ab = torch.einsum("sglra,sglrb->sglab", Ja, Jb) * m5
    same = (1.0 - rs_ab)[..., None, None]            # pose_b == pose_a
    adj = rs_ab[..., None, None]                     # pose_b == pose_a + 1
    x0 = _window_sum(ab * same, offs_a, W)
    b0 = (_window_sum(aa, offs_a, W) + _window_sum(bb, offs_b, W)
          + x0 + x0.transpose(-1, -2))
    b1 = _window_sum(ab * adj, offs_a, W)
    return {"gw": gw, "b0": b0, "b1": b1, "g_pt": g_pt, "C": C, "F": F}


def assemble(ev: WEvaluation, plan: WindowPlan) -> BandAssembly:
    """One pass over window-layout Jacobians → banded normal equations."""
    w = assemble_windows(ev, plan.offs_a, plan.offs_b, plan.rs_ab,
                         plan.mask, plan.W)
    B_band = w["b0"].new_zeros((plan.n_poses, plan.W, POSE_DOF, POSE_DOF))
    B_band[:, 0] = plan.fold(w["b0"])
    if plan.W > 1:
        B_band[:, 1] = plan.fold(w["b1"])
    return BandAssembly(g_cam=plan.fold(w["gw"]), g_pt=w["g_pt"], C=w["C"],
                        F=w["F"], B_band=B_band)


# --- band operators ----------------------------------------------------------

#: poses per dense segment of the band's cluster_jacobi preconditioner
CLUSTER_SEGMENT = 16


def make_band_preconditioner(S_band: torch.Tensor, kind: str,
                             segment: int = CLUSTER_SEGMENT):
    """Preconditioner for PCG on the banded S.

    kind = "schur_jacobi" (alias "jacobi"): per-pose 6×6 diagonal blocks
    (Ceres SCHUR_JACOBI), inverted in closed form.

    kind = "cluster_jacobi": contiguous ``segment``-pose blocks of the
    band, each factored dense.  On a trajectory the clusters of
    co-visible cameras are contiguous pose segments, so the cluster
    preconditioner is a block-diagonal-by-segment slice of the band: it
    keeps all coupling within a segment and drops only the terms across
    a boundary.  One batched (6·segment)² Cholesky per solve step and a
    batched Cholesky solve per CG iteration.
    """
    P, W = S_band.shape[0], S_band.shape[1]
    if kind in ("jacobi", "schur_jacobi"):
        from .schur import invert_6x6_psd
        Minv = invert_6x6_psd(S_band[:, 0])

        def apply(r_flat):
            return torch.bmm(Minv, r_flat.reshape(P, POSE_DOF, 1)).reshape(-1)

        return apply
    if kind != "cluster_jacobi":
        raise ValueError(kind)

    from .pcg import batched_cho_solve, batched_cholesky
    K = min(segment, P)
    nseg = -(-P // K)
    D = K * POSE_DOF
    L = batched_cholesky(band_segments(S_band, K))
    n_pad = nseg * D - P * POSE_DOF

    def apply(r_flat):
        r = torch.cat([r_flat, r_flat.new_zeros((n_pad,))]).reshape(nseg, D)
        return batched_cho_solve(L, r).reshape(-1)[:P * POSE_DOF]

    return apply


def band_segments(S_band: torch.Tensor, K: int) -> torch.Tensor:
    """Dense (nseg, 6K, 6K) diagonal segments of the symmetric band:
    block (i, j) of a segment is S_band[p_i, j − i] for 0 ≤ j − i < W, its
    transpose below the diagonal, zero elsewhere.  Rows past the last
    pose get identity diagonal blocks."""
    P, W = S_band.shape[0], S_band.shape[1]
    nseg = -(-P // K)
    dev = S_band.device
    pad = S_band.new_zeros((nseg * K - P, W, POSE_DOF, POSE_DOF))
    pad[:, 0] = torch.eye(POSE_DOF, dtype=S_band.dtype, device=dev)
    Sp = torch.cat([S_band, pad]).reshape(nseg, K, W, POSE_DOF, POSE_DOF)
    ar = torch.arange(K, device=dev)
    d = ar[None, :] - ar[:, None]                               # j − i
    upper = Sp[:, ar[:, None], d.clamp(0, W - 1)]    # (nseg, K, K, 6, 6)
    in_band = ((d >= 0) & (d < W)).to(S_band.dtype)[None, :, :, None, None]
    strict = (d > 0).to(S_band.dtype)[None, :, :, None, None]
    upper = upper * in_band
    M = upper + (upper * strict).permute(0, 2, 1, 4, 3)
    D = K * POSE_DOF
    return M.permute(0, 1, 3, 2, 4).reshape(nseg, D, D)


def band_rows(S_band: torch.Tensor):
    """The symmetric banded S as dense block rows.

    S_band stores the upper band: S[p, p+d] = S_band[p, d], d ∈ [0, W).
    Returns ``rows`` (P, 6, (2W−1)·6), pose p's row of S over its 2W−1
    neighbours (the W at and above it, then the W−1 below, blocks beyond
    either end zero), and ``nbr`` (P, 2W−1), the pose of each block column
    (clamped into range where the block is zero).
    """
    P, W = S_band.shape[0], S_band.shape[1]
    dev = S_band.device
    p = torch.arange(P, device=dev)[:, None]
    d_up = torch.arange(W, device=dev)[None, :]
    d_dn = torch.arange(1, W, device=dev)[None, :]
    up = S_band * (p + d_up < P).to(S_band.dtype)[:, :, None, None]
    # S[p, p−d] = S_band[p−d, d]ᵀ
    below = S_band[(p - d_dn).clamp(min=0), d_dn].transpose(-1, -2)
    below = below * (p - d_dn >= 0).to(S_band.dtype)[:, :, None, None]
    blocks = torch.cat([up, below], dim=1)            # (P, 2W−1, 6, 6)
    nbr = torch.cat([p + d_up, p - d_dn], dim=1).clamp(0, P - 1)
    rows = blocks.permute(0, 2, 1, 3).reshape(P, POSE_DOF,
                                              (2 * W - 1) * POSE_DOF)
    return rows, nbr


def make_band_matvec(S_band: torch.Tensor):
    """q = S·x for the symmetric banded S, x and q flat (P·6,): the block
    rows are laid out once, and a product is one gather of x's
    neighbours and one batched matrix-vector product."""
    rows, nbr = band_rows(S_band)
    P = S_band.shape[0]

    def matvec(x_flat: torch.Tensor) -> torch.Tensor:
        xn = x_flat.reshape(P, POSE_DOF)[nbr].reshape(P, -1, 1)
        return torch.bmm(rows, xn).reshape(-1)

    return matvec
