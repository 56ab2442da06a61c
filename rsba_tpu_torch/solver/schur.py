"""Schur-complement solver: landmark elimination + dense Cholesky.

Counterpart of ``rsba_tpu/solver/schur.py`` (Ceres ``DENSE_SCHUR``): the
camera-point matrix Eᵀ is stored densely per point, A (M, 3, Dc), and

    E C_λ⁻¹ Eᵀ = Σ_j A_jᵀ (C_λ⁻¹)_j A_j

is one (3M × Dc)ᵀ(3M × Dc) matmul; the per-point 3×3 inverses are a
batched closed form.  Landmarks never enter the factored system.  Also
here: the Ceres LM diagonal and the closed-form inverses of small
symmetric positive definite blocks that the banded solver shares.

Tangent layout: camera vector x_cam = [poses (P·6) | intrinsics (K·ni)],
points eliminated.  Column bases: pose p → p·6, intr k → 6P + k·ni.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..problem.types import POSE_DOF, Params, Problem
from ..utils import trace
from . import assembly, flatplan, residuals
from .options import SolverOptions
from .residuals import Evaluation


def invert_3x3_psd(C: torch.Tensor) -> torch.Tensor:
    """Batched closed-form inverse of symmetric PD 3×3 blocks (…, 3, 3)."""
    a, b, c = C[..., 0, 0], C[..., 0, 1], C[..., 0, 2]
    d, e, f = C[..., 1, 1], C[..., 1, 2], C[..., 2, 2]
    co00 = d * f - e * e
    co01 = c * e - b * f
    co02 = b * e - c * d
    det = a * co00 + b * co01 + c * co02
    inv_det = 1.0 / det
    co11 = a * f - c * c
    co12 = b * c - a * e
    co22 = a * d - b * b
    row0 = torch.stack([co00, co01, co02], dim=-1)
    row1 = torch.stack([co01, co11, co12], dim=-1)
    row2 = torch.stack([co02, co12, co22], dim=-1)
    return (torch.stack([row0, row1, row2], dim=-2)
            * inv_det[..., None, None])


def invert_6x6_psd(M: torch.Tensor) -> torch.Tensor:
    """Batched closed-form inverse of symmetric PD 6×6 blocks (…, 6, 6),
    blocked 2×2-of-3×3 Schur form on top of invert_3x3_psd.  Used for
    preconditioner factors, where its round-off only perturbs the CG
    convergence rate."""
    A = M[..., :3, :3]
    Bt = M[..., :3, 3:]
    C = M[..., 3:, 3:]
    Ai = invert_3x3_psd(A)
    Wb = Ai @ Bt
    Si = invert_3x3_psd(C - Bt.transpose(-1, -2) @ Wb)
    WSi = Wb @ Si
    top = torch.cat([Ai + WSi @ Wb.transpose(-1, -2), -WSi], dim=-1)
    bot = torch.cat([-WSi.transpose(-1, -2), Si], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _lm_scaled_damp(diag: torch.Tensor, radius, options: SolverOptions):
    """Ceres LM diagonal: clamp(diag)/radius, dead dims pinned to 1.
    ``radius`` is a float or a 0-dim tensor (the on-device loop's)."""
    dead = diag <= 0.0
    lm = torch.clamp(diag, options.min_lm_diagonal,
                     options.max_lm_diagonal) / radius
    return torch.where(dead, torch.ones_like(lm), lm), dead


def jacobi_scales(d_cam: torch.Tensor, d_pt: torch.Tensor,
                  options: SolverOptions):
    """Jacobi column scales s = 1/(1 + √diag) for the camera and point
    dims (1 on dead dims, and everywhere without ``jacobi_scaling``)."""
    if not options.jacobi_scaling:
        return torch.ones_like(d_cam), torch.ones_like(d_pt)

    def scale(d):
        return torch.where(
            d > 0, 1.0 / (1.0 + torch.sqrt(torch.clamp(d, min=0.0))), 1.0)

    return scale(d_cam), scale(d_pt)


def scaled_gradient_max(g_cam, s_cam, g_pt, s_pt) -> torch.Tensor:
    """max |g| of the unscaled gradient from its Jacobi-scaled blocks."""
    unscale = lambda g, s: g / torch.where(s == 0, 1.0, s)  # noqa: E731
    return torch.maximum(unscale(g_cam, s_cam).abs().max(),
                         unscale(g_pt, s_pt.reshape(g_pt.shape)).abs().max())


# --- camera-side Jacobian entries --------------------------------------------

class CamEntry(NamedTuple):
    """One camera-side Jacobian slot: J (N, 2, w) and its column base
    (N,) in the camera tangent vector."""
    J: torch.Tensor
    base: torch.Tensor
    width: int

    def cols(self) -> torch.Tensor:
        """(N, w) columns of the camera tangent vector."""
        return self.base[:, None] + torch.arange(self.width,
                                                 device=self.base.device)


def camera_entries(ev: Evaluation, problem: Problem,
                   shapes: assembly.TangentShapes) -> list:
    """Static list of camera-side Jacobian entries per observation.
    Global shutter: the pose_b Jacobian is identically zero, so its entry
    is dropped."""
    obs = problem.obs
    entries = [CamEntry(ev.J_pose[:, :, 0, :], obs.pose_a.long() * POSE_DOF,
                        POSE_DOF)]
    if problem.model.rolling_shutter:
        entries.append(CamEntry(ev.J_pose[:, :, 1, :],
                                obs.pose_b.long() * POSE_DOF, POSE_DOF))
    if shapes.ni > 0:
        p6 = shapes.n_poses * POSE_DOF
        entries.append(CamEntry(ev.J_intr,
                                p6 + obs.intr_idx.long() * shapes.ni,
                                shapes.ni))
    return entries


def scale_evaluation(ev: Evaluation, problem: Problem,
                     shapes: assembly.TangentShapes, s_cam: torch.Tensor,
                     s_pt: torch.Tensor) -> Evaluation:
    """Apply Jacobi column scaling to all Jacobian blocks.
    s_cam: (Dc,) per camera-tangent dim; s_pt: (M·3,) per point dim."""
    obs = problem.obs
    ar6 = torch.arange(POSE_DOF, device=s_cam.device)
    sa = s_cam[(obs.pose_a.long() * POSE_DOF)[:, None] + ar6]
    sb = s_cam[(obs.pose_b.long() * POSE_DOF)[:, None] + ar6]
    J_pose = ev.J_pose * torch.stack([sa, sb], dim=1)[:, None, :, :]
    J_intr = ev.J_intr
    if shapes.ni > 0:
        p6 = shapes.n_poses * POSE_DOF
        si = s_cam[(p6 + obs.intr_idx.long() * shapes.ni)[:, None]
                   + torch.arange(shapes.ni, device=s_cam.device)]
        J_intr = J_intr * si[:, None, :]
    sp = s_pt.reshape(shapes.n_points, 3)[obs.point.long()]
    return Evaluation(r=ev.r, cost=ev.cost, J_pose=J_pose, J_intr=J_intr,
                      J_pt=ev.J_pt * sp[:, None, :])


# --- dense B and E -----------------------------------------------------------

def _add_blocks(out: torch.Tensor, blocks: torch.Tensor, rows: torch.Tensor,
                cols: torch.Tensor, lead=None) -> None:
    """out[(lead,) rows_u + i, cols_u + k] += blocks[u, i, k] for blocks at
    places that are distinct within this call (read, add, write)."""
    wi, wk = blocks.shape[-2], blocks.shape[-1]
    r = (rows[:, None] + torch.arange(wi, device=out.device))[:, :, None]
    c = (cols[:, None] + torch.arange(wk, device=out.device))[:, None, :]
    idx = (r, c) if lead is None else (lead[:, None, None], r, c)
    out[idx] = out[idx] + blocks


def assemble_B(ev: Evaluation, problem: Problem,
               shapes: assembly.TangentShapes,
               plans: flatplan.FlatPlans) -> torch.Tensor:
    """Dense camera-camera block B = Σ J_camᵀ J_cam (Dc, Dc): per-block
    products reduced by key, each unique block placed once."""
    Dc = shapes.cam_dim
    p6 = shapes.n_poses * POSE_DOF
    ni = shapes.ni
    rs = problem.model.rolling_shutter
    B = ev.r.new_zeros((Dc, Dc))
    prod = lambda Ji, Jk: torch.einsum("nri,nrk->nik", Ji, Jk)  # noqa: E731
    Ja = ev.J_pose[:, :, 0, :]
    dev = B.device

    def place_diag(blocks, base0, w):
        at = base0 + torch.arange(blocks.shape[0], device=dev) * w
        _add_blocks(B, blocks, at, at)

    def place_pair(pp, blocks, base_i, wi, base_k, wk):
        ri, ck = base_i + pp.pos_i * wi, base_k + pp.pos_k * wk
        _add_blocks(B, blocks, ri, ck)
        _add_blocks(B, blocks.transpose(-1, -2), ck, ri)

    place_diag(plans.pose_a.reduce(prod(Ja, Ja)), 0, POSE_DOF)
    if rs:
        Jb = ev.J_pose[:, :, 1, :]
        place_diag(plans.pose_b.reduce(prod(Jb, Jb)), 0, POSE_DOF)
        place_pair(plans.ab, plans.ab.group.reduce(prod(Ja, Jb)),
                   0, POSE_DOF, 0, POSE_DOF)
    if ni > 0:
        Ji = ev.J_intr
        place_diag(plans.intr.reduce(prod(Ji, Ji)), p6, ni)
        place_pair(plans.ai, plans.ai.group.reduce(prod(Ja, Ji)),
                   0, POSE_DOF, p6, ni)
        if rs:
            place_pair(plans.bi, plans.bi.group.reduce(prod(Jb, Ji)),
                       0, POSE_DOF, p6, ni)
    return B


def assemble_E(ev: Evaluation, problem: Problem,
               shapes: assembly.TangentShapes,
               plans: flatplan.FlatPlans) -> torch.Tensor:
    """Eᵀ stored per point: A (M, 3, Dc) with A_j = E_jᵀ; A[j, :, cols_i]
    sums J_pt_iᵀ J_cam_i over the observations i of point j."""
    A = ev.r.new_zeros((shapes.n_points, 3, shapes.cam_dim))
    p6 = shapes.n_poses * POSE_DOF
    zero = torch.zeros((), dtype=torch.int64, device=A.device)
    for pp, J, base0, w in (
            (plans.pt_a, ev.J_pose[:, :, 0, :], 0, POSE_DOF),
            (plans.pt_b, ev.J_pose[:, :, 1, :], 0, POSE_DOF),
            (plans.pt_i, ev.J_intr, p6, shapes.ni)):
        if pp is None:
            continue
        blocks = pp.group.reduce(torch.einsum("nrp,nrw->npw", ev.J_pt, J))
        _add_blocks(A, blocks, zero.expand(pp.pos_i.shape[0]),
                    base0 + pp.pos_k * w, lead=pp.pos_i)
    return A


def gn_hessian_apply(ev: Evaluation, problem: Problem,
                     shapes: assembly.TangentShapes,
                     plans: flatplan.FlatPlans, dx_cam: torch.Tensor,
                     dx_pt: torch.Tensor):
    """Matrix-free Gauss-Newton Hessian product (undamped):
    (Hx_cam, Hx_pt) = J̃ᵀ(J̃·[dx_cam; dx_pt]), dx_pt (M, 3)."""
    u = torch.einsum("nrp,np->nr", ev.J_pt, dx_pt[problem.obs.point.long()])
    for e in camera_entries(ev, problem, shapes):
        u = u + torch.einsum("nrw,nw->nr", e.J, dx_cam[e.cols()])
    jtu = lambda J: torch.einsum("nrw,nr->nw", J, u)  # noqa: E731
    return (assembly.camera_reduce(ev, problem, shapes, plans, jtu),
            plans.point.reduce(jtu(ev.J_pt)))


#: dense-Schur memory guard: refuse if Eᵀ and B would exceed this
_DENSE_SCHUR_MAX_BYTES = 2 << 30


def make_dense_schur_solver(problem: Problem, options: SolverOptions):
    """(prepare, solve_step) for the LM loop: DENSE_SCHUR.

    ``assemble_E`` materialises Eᵀ as (M, 3, Dc), which grows with the
    product of points and cameras; a problem whose Eᵀ and B would not fit
    the guard is refused here, not in the middle of a solve, and belongs
    to ``iterative_schur`` or the banded window solver.

    Device spans (``utils/trace.py``, in a graph captured while tracing):
    ``evaluate`` (the Jacobians, diag(J̃ᵀJ̃) and the Jacobi scaling) and
    ``assemble`` (the gradient, B, Eᵀ and C) in ``prepare``;
    ``reduced_system`` (the damping, C_λ⁻¹ and S) and ``factor_solve``
    (the Cholesky, the solves and the refinement sweep) in ``solve_step``.
    """
    shapes = assembly.static_shapes(problem)
    M, Dc = shapes.n_points, shapes.cam_dim
    itemsize = problem.obs.uv.element_size()
    nbytes = (M * 3 * Dc + Dc ** 2) * itemsize
    if nbytes > _DENSE_SCHUR_MAX_BYTES:
        raise ValueError(
            f"dense_schur would materialize ~{nbytes / 2**30:.1f} GiB "
            f"(M={M}, Dc={Dc}); use linear_solver='iterative_schur' "
            f"(matrix-free PCG) or 'auto' for problems this size")
    plans = flatplan.build_flat_plans(problem)

    def prepare(params: Params):
        # The Jacobi scales read diag(J̃ᵀJ̃), so its reduction is timed
        # with the evaluation it scales.
        with trace.device_span("evaluate"):
            ev = residuals.evaluate(params, problem)
            d_cam, d_pt = assembly.jtj_diag(ev, problem, shapes, plans)
            s_cam, s_pt = jacobi_scales(d_cam, d_pt, options)
            s_pt = s_pt.reshape(-1)
            ev = scale_evaluation(ev, problem, shapes, s_cam, s_pt)
        with trace.device_span("assemble"):
            g_pose, g_intr, g_pt = assembly.gradient_blocks(ev, problem,
                                                            shapes, plans)
            g_cam = torch.cat([g_pose.reshape(-1), g_intr.reshape(-1)])
            B = assemble_B(ev, problem, shapes, plans)
            A = assemble_E(ev, problem, shapes, plans)
            C = assembly.point_hessian_blocks(ev, plans)
        return {
            "cost": ev.cost, "ev": ev, "g_cam": g_cam, "g_pt": g_pt,
            "B": B, "A": A, "C": C, "s_cam": s_cam, "s_pt": s_pt,
            "gradient_max_norm": scaled_gradient_max(g_cam, s_cam, g_pt,
                                                     s_pt),
        }

    def hessian_apply(ev, dxc, dxp):
        return gn_hessian_apply(ev, problem, shapes, plans, dxc, dxp)

    def solve_step(aux, radius):
        ev = aux["ev"]
        B, A, C = aux["B"], aux["A"], aux["C"]
        g_cam, g_pt = aux["g_cam"], aux["g_pt"]

        with trace.device_span("reduced_system"):
            # LM damping in scaled space.
            lm_cam, _ = _lm_scaled_damp(torch.diagonal(B), radius, options)
            c_diag = torch.diagonal(C, dim1=-2, dim2=-1)        # (M, 3)
            lm_pt, _ = _lm_scaled_damp(c_diag.reshape(-1), radius, options)
            lm_pt = lm_pt.reshape(M, 3)
            C_inv = invert_3x3_psd(C + torch.diag_embed(lm_pt))

            # Reduced system: S = B_λ − Σ_j A_jᵀ C_j⁻¹ A_j.
            Y = torch.einsum("mab,mbd->mad", C_inv, A)           # (M, 3, Dc)
            S = (B + torch.diag(lm_cam)
                 - A.reshape(M * 3, Dc).T @ Y.reshape(M * 3, Dc))

        def schur_solve(rc, rp):
            """Solve the damped full system K·[dc; dp] = [rc; rp] via S."""
            w = torch.einsum("mab,mb->ma", C_inv, rp)
            rhs = rc - torch.einsum("mad,ma->d", A, w)
            dc = torch.cholesky_solve(rhs[:, None], L)[:, 0]
            dp = torch.einsum("mab,mb->ma", C_inv,
                              rp - torch.einsum("mad,d->ma", A, dc))
            return dc, dp

        with trace.device_span("factor_solve"):
            L, _ = torch.linalg.cholesky_ex(S, check_errors=False)
            dxc, dxp = schur_solve(-g_cam, -g_pt)
            # Full-system iterative refinement against the matrix-free
            # damped operator (J̃ᵀJ̃ + λD²): corrects both the Cholesky and
            # the cancellation in forming S = B − E C⁻¹ Eᵀ.
            for _ in range(options.refinement_steps):
                Hx_cam, Hx_pt = hessian_apply(ev, dxc, dxp)
                cc, cp = schur_solve(-g_cam - (Hx_cam + lm_cam * dxc),
                                     -g_pt - (Hx_pt + lm_pt * dxp))
                dxc = dxc + cc
                dxp = dxp + cp

        # Predicted decrease via the cancellation-free LM identity: with
        # (H + λD²)δ = −g exactly, −gᵀδ − ½δᵀHδ = ½(δᵀλD²δ − gᵀδ), a sum
        # of two nonnegative terms.
        gTdx = torch.dot(g_cam, dxc) + torch.sum(g_pt * dxp)
        dDd = torch.sum(lm_cam * dxc * dxc) + torch.sum(lm_pt * dxp * dxp)
        predicted = 0.5 * (dDd - gTdx)
        dx = torch.cat([aux["s_cam"] * dxc,
                        (aux["s_pt"].reshape(M, 3) * dxp).reshape(-1)])
        return dx, predicted, torch.zeros((), dtype=torch.int32,
                                          device=dx.device)

    prepare.hessian_apply = hessian_apply
    return prepare, solve_step
