"""Banded Schur solver driven by the fused evaluate+assemble kernel.

Counterpart of ``rsba_tpu/solver/banded_tpu.py``.  ``prepare`` runs the
fused kernel (``kernels/fused.py``: the CUDA kernel on CUDA tensors, its
plain PyTorch version otherwise) and folds its window sums into poses
(``evaluate_fold``), then applies Jacobi scaling (``scale_system``); the
sharded engine (``dist/banded_sharded.py``) all-reduces between the two
halves.  ``solve_step`` works on the kernel's planes
layout, where per-point quantities carry the point axis G last:

    g_pt (NR, 3, G),  C (NR, 6, G) packed symmetric,  F (NR, W, 18, G)

Internal parameter layout: points as (NR, 3, G) planes.  The pairwise
cost decrease always differences two passes of the same plain residual
path (``banded.residuals_raw``), never the kernel against it; the
on-device loop carries the per-slot ρ of the accepted parameters
(``rho_slots``), so an attempt costs one residual pass
(``cost_decrease_pair``).
"""
from __future__ import annotations

import dataclasses

import torch

from ..geometry import quaternion as quat
from ..kernels import fused
from ..problem.types import POSE_DOF, Params, Problem
from . import banded
from .options import SolverOptions
from .pcg import pcg
from .schur import _lm_scaled_damp, jacobi_scales
from .window import WindowPlan

C6_DIAG = fused.C6_DIAG
C6_PAIRS = fused.C6_PAIRS

#: packed symmetric component index for (x, y) pairs
_C6_AT = {(0, 0): 0, (0, 1): 1, (1, 0): 1, (0, 2): 2, (2, 0): 2,
          (1, 1): 3, (1, 2): 4, (2, 1): 4, (2, 2): 5}


# --- layout helpers ----------------------------------------------------------

def to_internal(params: Params, plan: WindowPlan) -> Params:
    """External (M, 3) points → planes (NR, 3, G)."""
    pts = plan.gather_points(params.points)          # (NR, G, 3)
    return params.replace(points=pts.transpose(1, 2).contiguous())


def to_external(params: Params, plan: WindowPlan) -> Params:
    """Planes (NR, 3, G) → external (M, 3)."""
    return params.replace(
        points=plan.scatter_points(params.points.transpose(1, 2)))


def _as_v1(params: Params) -> Params:
    """Planes params → window-order (NR·G, 3) params for banded.py's
    residual path."""
    return params.replace(points=params.points.transpose(1, 2).reshape(-1, 3))


def invert_sym3_planes(c6: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of symmetric PD 3×3 packed planes (NR, 6, G)."""
    a, b, c, d, e, f = c6.unbind(1)                   # 00 01 02 11 12 22
    co00 = d * f - e * e
    co01 = c * e - b * f
    co02 = b * e - c * d
    det = a * co00 + b * co01 + c * co02
    co11 = a * f - c * c
    co12 = b * c - a * e
    co22 = a * d - b * b
    return (torch.stack([co00, co01, co02, co11, co12, co22], dim=1)
            * (1.0 / det)[:, None])


def _sym_full(c6: torch.Tensor) -> torch.Tensor:
    """(NR, 6, G) packed symmetric → (NR, 3, 3, G) full."""
    comp = c6.unbind(1)
    return torch.stack([torch.stack([comp[_C6_AT[(x, y)]] for y in range(3)],
                                    dim=1) for x in range(3)], dim=1)


def _c6_diag(c6: torch.Tensor) -> torch.Tensor:
    """Diagonal components of packed symmetric planes: (NR, 3, G).  Built
    from slices: an index list would be copied from the host at each
    call, which a CUDA graph capture does not allow."""
    return torch.stack([c6[:, i] for i in C6_DIAG], dim=1)


def _c6_add_diag(c6: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Packed symmetric planes (NR, 6, G) plus a diagonal d (NR, 3, G)."""
    zero = torch.zeros_like(d[:, 0])
    return c6 + torch.stack([d[:, 0], zero, zero, d[:, 1], zero, d[:, 2]],
                            dim=1)


def _cinv_apply(c6inv: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(NR, 6, G) packed symmetric × (NR, 3, G) → (NR, 3, G)."""
    return torch.stack([
        sum(c6inv[:, _C6_AT[(x, y)], :] * v[:, y, :] for y in range(3))
        for x in range(3)], dim=1)


def fcf_band_planes(F: torch.Tensor, c6inv: torch.Tensor,
                    plan: WindowPlan) -> torch.Tensor:
    """F C⁻¹ Fᵀ folded into the (P, W, 6, 6) band, planes layout.

    One batched matmul computes all (w, w') window pairs: both sides are
    (NR, W·6, 3·G) with the point component and G flattened into the
    contraction axis; the right side is a pure reshape of F (a-major,
    p-minor).  Band blocks (w, w + d) are then gathered and folded once.
    """
    NR, W, _, G = F.shape
    F5 = F.view(NR, W, 6, 3, G)
    Y = torch.einsum("nwaxg,nxyg->nwayg", F5, _sym_full(c6inv))   # F C⁻¹
    full = torch.bmm(Y.reshape(NR, W * 6, 3 * G),
                     F.reshape(NR, W * 6, 3 * G).transpose(1, 2))
    full6 = full.view(NR, W, 6, W, 6).permute(0, 1, 3, 2, 4)   # n w w' a b
    ar = torch.arange(W, device=F.device)
    wd = ar[:, None] + ar[None, :]                                # w + d
    gath = full6[:, ar[:, None], wd % W]                          # n w d a b
    gath = gath * (wd < W).to(F.dtype)[None, :, :, None, None]
    return plan.fold(gath.reshape(NR, W, W * 36)).reshape(
        plan.n_poses, W, 6, 6)


def e_apply_planes(F: torch.Tensor, y0: torch.Tensor,
                   plan: WindowPlan) -> torch.Tensor:
    """(E·y)_cam from planes: F (NR, W, 18, G), y0 (NR, 3, G) → (P, 6)."""
    NR, W, _, G = F.shape
    return plan.fold(torch.einsum("nwaxg,nxg->nwa", F.view(NR, W, 6, 3, G),
                                  y0))


def et_apply_planes(F: torch.Tensor, pw: torch.Tensor) -> torch.Tensor:
    """Eᵀ·p per point: F (NR, W, 18, G), pw (NR, W, 6) → (NR, 3, G)."""
    NR, W, _, G = F.shape
    return torch.einsum("nwaxg,nwa->nxg", F.view(NR, W, 6, 3, G), pw)


# --- prepare -----------------------------------------------------------------

@dataclasses.dataclass
class KernelStatics:
    """The kernel's per-problem inputs, laid out once per solve."""
    ptf: torch.Tensor    # (NR, G)
    uv: torch.Tensor     # (NR, 2, L, G)
    tt: torch.Tensor     # (NR, L, G)
    mask: torch.Tensor   # (NR, L, G)
    offs: torch.Tensor   # (NR, L, G) int32
    rsf: torch.Tensor    # (NR, L, G)


def kernel_statics(plan: WindowPlan, problem: Problem) -> KernelStatics:
    c = lambda a: a.contiguous()  # noqa: E731
    return KernelStatics(
        ptf=c(plan.gather_point_scalar(problem.point_free)),
        uv=c(plan.uv.permute(0, 3, 2, 1)), tt=c(plan.t.transpose(1, 2)),
        mask=c(plan.mask.transpose(1, 2)),
        offs=c(plan.offs_a.transpose(1, 2).to(torch.int32)),
        rsf=c(plan.rs_ab.transpose(1, 2)))


def kernel_inputs(params: Params, plan: WindowPlan, problem: Problem,
                  st: KernelStatics) -> tuple:
    """Positional inputs of ``fused.fused_evaluate_assemble``."""
    win = torch.cat([plan.pose_windows(params.q), plan.pose_windows(params.c),
                     plan.pose_windows(problem.pose_free)[..., None]], dim=-1)
    return (win.contiguous(), params.points.contiguous(), st.ptf, st.uv,
            st.tt, st.mask, st.offs, st.rsf, params.intr[0].contiguous())


def evaluate_fold(plan: WindowPlan, problem: Problem, params: Params,
                  evaluate, statics: KernelStatics) -> dict:
    """First half of ``prepare``: the fused evaluate+assemble and the fold
    of its window sums into poses.  ``evaluate`` is one of the
    kernels/fused.py entry points.  On a block of rows the cost, ``g_cam``,
    ``B0`` and ``B1`` are partial sums over its rows (the sharded engine
    all-reduces them); the point-side ``g_pt``, ``c6`` and ``F`` are the
    block's own."""
    out = evaluate(*kernel_inputs(params, plan, problem, statics),
                   model=problem.model, loss=problem.loss)
    P = plan.n_poses
    return {"cost": out["cost"], "g_cam": plan.fold(out["gw"]),
            "B0": plan.fold(out["b0"]).reshape(P, 6, 6),
            "B1": plan.fold(out["b1"]).reshape(P, 6, 6),
            "g_pt": out["g_pt"], "c6": out["c6"], "F": out["F"]}


def scale_system(plan: WindowPlan, options: SolverOptions, parts: dict,
                 gradient_max_norm: torch.Tensor) -> dict:
    """Second half of ``prepare``: Jacobi scaling of the folded system
    (``evaluate_fold``'s dict, whole over the poses)."""
    g_cam, B0, B1 = parts["g_cam"], parts["B0"], parts["B1"]
    g_pt, c6, F = parts["g_pt"], parts["c6"], parts["F"]
    s_cam, s_pt = jacobi_scales(torch.diagonal(B0, dim1=-2, dim2=-1),
                                _c6_diag(c6), options)  # (P, 6), (NR, 3, G)
    if options.jacobi_scaling:
        g_cam = g_cam * s_cam
        g_pt = g_pt * s_pt
        c6 = c6 * torch.stack([s_pt[:, p] * s_pt[:, q]
                               for (p, q) in C6_PAIRS], dim=1)
        NR, W, _, G = F.shape
        scw = plan.pose_windows(s_cam)               # (NR, W, 6)
        F = (F.view(NR, W, 6, 3, G) * scw[:, :, :, None, None]
             * s_pt[:, None, None, :, :]).reshape(NR, W, 18, G)
        s_next = torch.cat([s_cam[1:], torch.zeros_like(s_cam[:1])])
        B0 = B0 * s_cam[:, :, None] * s_cam[:, None, :]
        # B1 couples pose p with p + 1: scale its columns by s_cam[p + 1].
        B1 = B1 * s_cam[:, :, None] * s_next[:, None, :]
    return {"cost": parts["cost"], "g_cam": g_cam, "g_pt": g_pt, "c6": c6,
            "F": F, "B0": B0, "B1": B1, "s_cam": s_cam, "s_pt": s_pt,
            "gradient_max_norm": gradient_max_norm}


def prepare(plan: WindowPlan, problem: Problem, options: SolverOptions,
            params: Params, evaluate, statics: KernelStatics) -> dict:
    """Fused evaluate+assemble, window fold and Jacobi scaling."""
    parts = evaluate_fold(plan, problem, params, evaluate, statics)
    gmax = torch.maximum(parts["g_cam"].abs().max(),
                         parts["g_pt"].abs().max())
    return scale_system(plan, options, parts, gmax)


def rho_slots(plan: WindowPlan, problem: Problem, params: Params):
    """Per-slot robust costs ρ (NR, G, L) from the plain residual path.

    Both sides of a pairwise cost decrease must come from the same
    evaluator: the kernel and the plain path differ by round-off per slot,
    which near convergence is the order of function_tolerance·cost.  The
    on-device loop seeds ρ_ref here once per block and carries the
    accepted candidate's ρ forward."""
    return banded._rho(banded.residuals_raw(_as_v1(params), plan, problem),
                       problem.loss)


def cost_decrease_pair(plan: WindowPlan, problem: Problem, rho_ref,
                       cand: Params):
    """(Σ (ρ_ref − ρ_new)/2, ρ_new): one residual pass on the candidate;
    ρ_ref is the loop-carried ρ of the current parameters."""
    rho_new = rho_slots(plan, problem, cand)
    decrease = 0.5 * torch.sum(
        torch.where(plan.mask > 0, rho_ref - rho_new, 0.0))
    return decrease, rho_new


# --- solve step --------------------------------------------------------------

def reduced_system(plan: WindowPlan, options: SolverOptions, aux: dict,
                   radius, psum=None):
    """The damped reduced camera system of one step: the S_λ band
    (P, W, 6, 6), its right-hand side b (P, 6), the packed C_λ⁻¹ and the
    LM diagonals of the camera and point blocks.

    ``psum(fcf, ey)``, where given, sums the two point-side terms over
    the blocks of rows of a sharded solve (one all-reduce)."""
    P = plan.n_poses
    F, c6 = aux["F"], aux["c6"]
    d_cam = torch.diagonal(aux["B0"], dim1=-2, dim2=-1)
    lm_cam, _ = _lm_scaled_damp(d_cam.reshape(-1), radius, options)
    lm_cam = lm_cam.reshape(P, POSE_DOF)
    d_pt = _c6_diag(c6)
    lm_pt, _ = _lm_scaled_damp(d_pt.reshape(-1), radius, options)
    lm_pt = lm_pt.reshape(d_pt.shape)                # (NR, 3, G)
    c6inv = invert_sym3_planes(_c6_add_diag(c6, lm_pt))
    fcf = fcf_band_planes(F, c6inv, plan)
    ey = e_apply_planes(F, _cinv_apply(c6inv, -aux["g_pt"]), plan)
    if psum is not None:
        fcf, ey = psum(fcf, ey)
    # S_λ = B_λ − F C_λ⁻¹ Fᵀ on the band, b = −g_cam − E C_λ⁻¹ (−g_pt).
    S = -fcf
    S[:, 0] += aux["B0"] + torch.diag_embed(lm_cam)
    if plan.W > 1:
        S[:, 1] += aux["B1"]
    b = -aux["g_cam"] - ey
    return S, b, c6inv, lm_cam, lm_pt


def solve_step(plan: WindowPlan, options: SolverOptions, aux: dict,
               radius, psum=None):
    """Damped Schur solve: returns (dx, predicted decrease, CG iters).
    ``radius`` is a float or a 0-dim tensor.

    A sharded solve passes ``psum(*tensors)``, the sum of each tensor over
    the blocks of rows: the reduced system's point-side terms and the
    point terms of the predicted decrease go through it.  PCG then runs
    on the whole band, the same on every block, and back-substitution
    stays local."""
    P = plan.n_poses
    F, g_cam, g_pt = aux["F"], aux["g_cam"], aux["g_pt"]
    S, b, c6inv, lm_cam, lm_pt = reduced_system(plan, options, aux, radius,
                                                psum)
    dc_flat, r_cg, iters = pcg(
        banded.make_band_matvec(S),
        banded.make_band_preconditioner(S, options.preconditioner),
        b.reshape(-1), options.max_cg_iterations, options.cg_eta)
    dc = dc_flat.reshape(P, POSE_DOF)
    # Back-substitute landmarks.
    dp = _cinv_apply(c6inv, -g_pt - et_apply_planes(F, plan.pose_windows(dc)))

    pt_terms = torch.stack([torch.sum(g_pt * dp),
                            torch.sum(lm_pt * dp * dp)])
    if psum is not None:
        # lm_pt > 0, so a non-finite dp on any block makes dDd and the
        # predicted decrease non-finite on every block: all of them
        # reject the step alike.
        pt_terms, = psum(pt_terms)
    gTdx = torch.sum(g_cam * dc) + pt_terms[0]
    dDd = torch.sum(lm_cam * dc * dc) + pt_terms[1]
    predicted = 0.5 * (dDd - gTdx) - 0.5 * torch.dot(r_cg, dc_flat)
    dx = {"pose": aux["s_cam"] * dc, "pt": aux["s_pt"] * dp}
    return dx, predicted, iters


def apply_step(plan: WindowPlan, problem: Problem, params: Params, dx,
               ptf: torch.Tensor, psum=None):
    """Retract the step: quaternion ⊞ on rotations, additive elsewhere.
    Returns (new params, step norm, parameter norm); ``psum`` as in
    ``solve_step`` sums the point terms of the two norms."""
    d_pose = dx["pose"] * problem.pose_free[:, None]
    d_pt = dx["pt"] * ptf[:, None, :]
    new = params.replace(q=quat.boxplus(params.q, d_pose[:, :3]),
                         c=params.c + d_pose[:, 3:],
                         points=params.points + d_pt)
    pt_terms = torch.stack([torch.sum(d_pt ** 2),
                            torch.sum(params.points ** 2)])
    if psum is not None:
        pt_terms, = psum(pt_terms)
    step_norm = torch.sqrt(torch.sum(d_pose ** 2) + pt_terms[0])
    x_norm = torch.sqrt(
        torch.sum(params.c ** 2) + pt_terms[1]
        + torch.sum(params.q ** 2) + torch.sum(params.intr ** 2))
    return new, step_norm, x_norm


# --- solver-fns dict ---------------------------------------------------------

def pick_evaluator(options: SolverOptions, device: torch.device):
    """(the prepare's evaluator, whether it is the CUDA kernel) for
    ``options.evaluator`` on ``device``: "cuda" the kernel (raises on CPU
    tensors), "torch" its plain version, "auto" the kernel on a CUDA
    device and the plain version on the CPU."""
    evaluate = {"auto": fused.fused_evaluate_assemble,
                "cuda": fused.fused_evaluate_assemble_cuda,
                "torch": fused.fused_evaluate_assemble_reference,
                }[options.evaluator]
    return evaluate, (options.evaluator == "cuda"
                      or (options.evaluator == "auto"
                          and device.type != "cpu"))


def make_fused_solver_fns(problem: Problem, plan: WindowPlan,
                          options: SolverOptions) -> dict:
    """Phase functions for ``lm.solve``: fused prepare + planes solve_step.

    ``options.evaluator`` picks the prepare's evaluator
    (``pick_evaluator``).
    """
    from .lm import inlier_threshold
    thresh = inlier_threshold(problem)
    evaluate, use_kernel = pick_evaluator(options, problem.device)
    statics = kernel_statics(plan, problem)
    ptf = statics.ptf
    # Phase closures for the on-device loop (lm_device.py); ``bound`` is
    # passed back as their first argument.
    raw = {
        "bound": (plan, problem),
        "prepare": lambda b, p: prepare(b[0], b[1], options, p, evaluate,
                                        statics),
        "solve_step": lambda b, aux, radius: solve_step(b[0], options, aux,
                                                        radius),
        "apply_step": lambda b, p, dx: apply_step(b[0], b[1], p, dx, ptf),
        "cost_decrease": lambda b, po, pn: banded.cost_decrease(
            b[0], b[1], _as_v1(po), _as_v1(pn)),
        "rho_slots": lambda b, p: rho_slots(b[0], b[1], p),
        "cost_decrease_pair": lambda b, rho_ref, pn: cost_decrease_pair(
            b[0], b[1], rho_ref, pn),
    }
    return {
        "raw": raw,
        "prepare": lambda p: prepare(plan, problem, options, p, evaluate,
                                     statics),
        "solve_step": lambda aux, radius: solve_step(plan, options, aux,
                                                     radius),
        "apply_step": lambda p, dx: apply_step(plan, problem, p, dx, ptf),
        "cost": lambda p: banded.cost_only(plan, problem, _as_v1(p)),
        "cost_decrease": lambda a, b: banded.cost_decrease(
            plan, problem, _as_v1(a), _as_v1(b)),
        "error_stats": lambda p: banded.error_stats(plan, problem, _as_v1(p),
                                                    thresh),
        "to_internal": lambda p: to_internal(p, plan),
        "to_external": lambda p: to_external(p, plan),
        "engine": ("banded_schur", "cuda" if use_kernel else "torch"),
    }
