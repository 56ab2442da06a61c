"""Iterative Schur solver: preconditioned conjugate gradients on the
reduced camera system.

Counterpart of ``rsba_tpu/solver/pcg.py``.  ``pcg`` is the loop the flat
``iterative_schur`` engine runs, and the banded engine under
``cluster_jacobi``; the banded engine's block-Jacobi PCG is one kernel
(``kernels/band_pcg.py``), whose plain version repeats this loop.  The flat
engine never materialises S = B_λ − E C_λ⁻¹ Eᵀ: ``SchurFreeOperator``
applies it as five batched products over the observation axis, with
gathers and fixed-order segmented sums (``flatplan.GroupPlan``).

The loop state of ``pcg`` lives in tensors and no scalar is read back
inside it, so a whole solve step can be captured in a CUDA graph.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..problem.types import POSE_DOF, Params, Problem
from . import assembly, flatplan, residuals
from .options import SolverOptions
from .residuals import Evaluation
from .schur import (_lm_scaled_damp, camera_entries, invert_3x3_psd,
                    jacobi_scales, scale_evaluation, scaled_gradient_max)


def pcg(matvec, precond, b: torch.Tensor, max_iterations: int, eta: float):
    """Preconditioned CG on S_λ x = b; returns (x, final residual, iters).

    Stopping: ‖r‖ ≤ η‖b‖ (Ceres's per-solve forcing) or max_iterations.
    If the operator loses positive definiteness (pᵀq ≤ 0) or rᵀz ≤ 0,
    α and β freeze at 0 and the loop stops (‖r‖ is reported as −1).

    The loop always makes ``max_iterations`` passes.  A pass whose entry
    condition ``‖r‖ > tol`` is false leaves every field of the state as
    it is, so the state freezes where a loop with an early exit would
    have left it, and ``iters`` (a 0-dim int32 tensor) counts the live
    passes only.  Nothing is read back to the host.
    """
    bnorm = torch.linalg.vector_norm(b)
    tol = eta * bnorm
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    x = torch.zeros_like(b)
    r = b
    p = precond(r)
    rz = torch.dot(r, p)
    rnorm = bnorm
    k = torch.zeros((), dtype=torch.int32, device=b.device)
    for _ in range(max_iterations):
        live = rnorm > tol
        q = matvec(p)
        pq = torch.dot(p, q)
        # α = 0 on a frozen pass: x and r then come out as they went in.
        alpha = torch.where(live & (pq > 0), rz / pq, zero)
        x = torch.addcmul(x, alpha, p)
        r = torch.addcmul(r, alpha, q, value=-1.0)
        z = precond(r)
        rz_new = torch.dot(r, z)
        beta = torch.where(rz > 0, rz_new / rz, zero)
        stalled = torch.logical_or(pq <= 0, rz <= 0)
        rnorm_new = torch.where(stalled, -1.0, torch.linalg.vector_norm(r))
        p = torch.where(live, torch.addcmul(z, beta, p), p)
        rz = torch.where(live, rz_new, rz)
        rnorm = torch.where(live, rnorm_new, rnorm)
        k = k + live.to(torch.int32)
    return x, r, k


# --- matrix-free reduced camera system ---------------------------------------

class SchurFreeOperator(NamedTuple):
    """Matrix-free damped reduced camera system S_λ = B_λ − E C_λ⁻¹ Eᵀ."""
    ev: Evaluation
    problem: Problem
    shapes: assembly.TangentShapes
    lm_cam: torch.Tensor      # (Dc,) LM diagonal for the camera block
    C_inv: torch.Tensor       # (M, 3, 3) damped point-block inverses
    plans: flatplan.FlatPlans

    def _jcam_apply(self, p: torch.Tensor) -> torch.Tensor:
        """u = J_cam · p over all observations → (N, 2)."""
        u = torch.zeros_like(self.ev.r)
        for e in camera_entries(self.ev, self.problem, self.shapes):
            u = u + torch.einsum("nrw,nw->nr", e.J, p[e.cols()])
        return u

    def _jcam_transpose_apply(self, u: torch.Tensor) -> torch.Tensor:
        """J_camᵀ · u reduced into the camera tangent vector → (Dc,)."""
        return assembly.camera_reduce(
            self.ev, self.problem, self.shapes, self.plans,
            lambda J: torch.einsum("nrw,nr->nw", J, u))

    def _pt_reduce(self, u: torch.Tensor) -> torch.Tensor:
        """Σ_obs J_ptᵀ u per point → (M, 3)."""
        return self.plans.point.reduce(
            torch.einsum("nrd,nr->nd", self.ev.J_pt, u))

    def et_apply(self, p: torch.Tensor) -> torch.Tensor:
        """Eᵀ·p = Σ_obs J_ptᵀ (J_cam p) per point → (M, 3)."""
        return self._pt_reduce(self._jcam_apply(p))

    def e_apply(self, y: torch.Tensor) -> torch.Tensor:
        """E·y = J_camᵀ (J_pt · y[point]) → (Dc,)."""
        v = torch.einsum("nrd,nd->nr", self.ev.J_pt,
                         y[self.problem.obs.point.long()])
        return self._jcam_transpose_apply(v)

    def matvec(self, p: torch.Tensor) -> torch.Tensor:
        """q = S_λ · p (one pass: shares the J_cam·p product)."""
        u = self._jcam_apply(p)
        Bp = self._jcam_transpose_apply(u) + self.lm_cam * p
        y = torch.einsum("mab,mb->ma", self.C_inv, self._pt_reduce(u))
        return Bp - self.e_apply(y)

    def back_substitute(self, dc: torch.Tensor, g_pt: torch.Tensor):
        """dp = C_λ⁻¹ (−g_pt − Eᵀ dc): landmark recovery."""
        return torch.einsum("mab,mb->ma", self.C_inv,
                            -g_pt - self.et_apply(dc))


# --- Schur-Jacobi preconditioner ---------------------------------------------

def schur_jacobi_partial(ev: Evaluation, problem: Problem,
                         shapes: assembly.TangentShapes,
                         C_inv: torch.Tensor, plans: flatplan.FlatPlans):
    """Block diagonal of S (undamped): per-pose (P, 6, 6), per-intrinsics
    (K, ni, ni).  Exact B diagonal blocks; the E C⁻¹ Eᵀ part is summed
    per observation (exact when each (camera block, point) pair is
    observed once, else still a valid SPD preconditioner)."""
    Ci = C_inv[problem.obs.point.long()]

    def block(J, plan):
        bb = torch.einsum("nri,nrk->nik", J, J)
        f = torch.einsum("nrw,nrp->nwp", J, ev.J_pt)      # F = J_camᵀ J_pt
        fcf = torch.einsum("nwp,npq,nvq->nwv", f, Ci, f)
        return plan.reduce(bb - fcf)

    D_pose = block(ev.J_pose[:, :, 0, :], plans.pose_a)
    if problem.model.rolling_shutter:
        D_pose = D_pose + block(ev.J_pose[:, :, 1, :], plans.pose_b)
    if shapes.ni > 0:
        D_intr = block(ev.J_intr, plans.intr)
    else:
        D_intr = ev.r.new_zeros((shapes.n_intr, 0, 0))
    return D_pose, D_intr


def add_lm_diag(D_pose, D_intr, lm_cam, shapes: assembly.TangentShapes):
    """Add the LM diagonal (which also pins dead/constant dims to 1)."""
    p6 = shapes.n_poses * POSE_DOF
    D_pose = D_pose + torch.diag_embed(
        lm_cam[:p6].reshape(shapes.n_poses, POSE_DOF))
    if shapes.ni > 0:
        D_intr = D_intr + torch.diag_embed(
            lm_cam[p6:].reshape(shapes.n_intr, shapes.ni))
    return D_pose, D_intr


def schur_jacobi_blocks(ev, problem, shapes, lm_cam, C_inv, plans):
    """Damped block diagonal of S_λ."""
    D_pose, D_intr = schur_jacobi_partial(ev, problem, shapes, C_inv, plans)
    return add_lm_diag(D_pose, D_intr, lm_cam, shapes)


def batched_cholesky(blocks: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of (…, n, n) blocks without the error check
    that reads back to the host; a block that is not positive definite
    gives a non-finite step, which the trust-region loop rejects."""
    L, _ = torch.linalg.cholesky_ex(blocks, check_errors=False)
    return L


def batched_cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (L Lᵀ) x = b for a batch of vectors b (…, n): two batched
    triangular solves.  (``torch.cholesky_solve`` on a CUDA batch goes
    through MAGMA, which allocates device memory itself and so cannot be
    captured in a CUDA graph.)"""
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y,
                                         upper=True)[..., 0]


def make_block_preconditioner(D_pose, D_intr,
                              shapes: assembly.TangentShapes):
    """Factor the diagonal blocks once; M⁻¹·r as batched Cholesky solves."""
    L_pose = batched_cholesky(D_pose)
    ni = shapes.ni
    L_intr = batched_cholesky(D_intr) if ni > 0 else None
    p6 = shapes.n_poses * POSE_DOF

    def apply(r: torch.Tensor) -> torch.Tensor:
        zp = batched_cho_solve(
            L_pose, r[:p6].reshape(shapes.n_poses, POSE_DOF)).reshape(-1)
        if ni > 0:
            zi = batched_cho_solve(
                L_intr, r[p6:].reshape(shapes.n_intr, ni)).reshape(-1)
            return torch.cat([zp, zi])
        return zp

    return apply


def _jacobi_apply(D_pose, D_intr, shapes, r):
    """Plain point-Jacobi: divide by the block diagonals' diagonal."""
    d = torch.diagonal(D_pose, dim1=-2, dim2=-1).reshape(-1)
    if shapes.ni > 0:
        d = torch.cat([d, torch.diagonal(D_intr, dim1=-2,
                                         dim2=-1).reshape(-1)])
    return r / torch.clamp(d, min=1e-30)


# --- the engine's phase functions --------------------------------------------

def make_iterative_schur_solver(problem: Problem, options: SolverOptions):
    """(prepare, solve_step) for the LM loop: ITERATIVE_SCHUR.

    preconditioner="cluster_jacobi" enables the visibility-clustered
    tier (``solver/cluster.py``): camera clusters from greedy
    co-visibility agglomeration, per-cluster dense blocks of S factored
    in one batch.  (On rolling-shutter problems the cluster coupling is
    built from the pose_a Jacobian side only, which stays a valid SPD
    preconditioner.)
    """
    shapes = assembly.static_shapes(problem)
    plans = flatplan.build_flat_plans(problem)
    cluster_plan = None
    if options.preconditioner == "cluster_jacobi":
        from . import cluster as cluster_mod
        cluster_plan = cluster_mod.build_cluster_plan(problem, plans.point)

    def prepare(params: Params):
        ev = residuals.evaluate(params, problem)
        d_cam, C_diag = assembly.jtj_diag(ev, problem, shapes, plans)
        s_cam, s_pt = jacobi_scales(d_cam, C_diag, options)
        ev = scale_evaluation(ev, problem, shapes, s_cam, s_pt.reshape(-1))
        g_pose, g_intr, g_pt = assembly.gradient_blocks(ev, problem, shapes,
                                                        plans)
        g_cam = torch.cat([g_pose.reshape(-1), g_intr.reshape(-1)])
        return {
            "cost": ev.cost, "ev": ev, "g_cam": g_cam, "g_pt": g_pt,
            "C": assembly.point_hessian_blocks(ev, plans),
            "d_cam": assembly.jtj_diag(ev, problem, shapes, plans)[0],
            "s_cam": s_cam, "s_pt": s_pt,
            "gradient_max_norm": scaled_gradient_max(g_cam, s_cam, g_pt,
                                                     s_pt),
        }

    def solve_step(aux, radius):
        ev = aux["ev"]
        M = shapes.n_points
        g_cam, g_pt, C = aux["g_cam"], aux["g_pt"], aux["C"]

        lm_cam, _ = _lm_scaled_damp(aux["d_cam"], radius, options)
        c_diag = torch.diagonal(C, dim1=-2, dim2=-1).reshape(-1)
        lm_pt, _ = _lm_scaled_damp(c_diag, radius, options)
        lm_pt_b = lm_pt.reshape(M, 3)
        C_inv = invert_3x3_psd(C + torch.diag_embed(lm_pt_b))

        op = SchurFreeOperator(ev=ev, problem=problem, shapes=shapes,
                               lm_cam=lm_cam, C_inv=C_inv, plans=plans)
        D_pose, D_intr = schur_jacobi_blocks(ev, problem, shapes, lm_cam,
                                             C_inv, plans)
        # Reduced rhs: b = −g_cam − E C_λ⁻¹ (−g_pt).
        b = -g_cam - op.e_apply(torch.einsum("mab,mb->ma", C_inv, -g_pt))

        if cluster_plan is not None:
            from . import cluster as cluster_mod
            precond = cluster_mod.make_cluster_preconditioner(
                cluster_plan, D_pose, D_intr, shapes, ev, problem, C_inv)
        elif options.preconditioner == "schur_jacobi":
            precond = make_block_preconditioner(D_pose, D_intr, shapes)
        else:
            def precond(r):
                return _jacobi_apply(D_pose, D_intr, shapes, r)

        dc, r_cg, iters = pcg(op.matvec, precond, b,
                              options.max_cg_iterations, options.cg_eta)
        dp = op.back_substitute(dc, g_pt)

        # Predicted decrease: the cancellation-free exact-solve identity
        # ½(δᵀλD²δ − gᵀδ) corrected by the CG residual (r_cg in the camera
        # rows, 0 in the point rows).
        gTdx = torch.dot(g_cam, dc) + torch.sum(g_pt * dp)
        dDd = torch.sum(lm_cam * dc * dc) + torch.sum(lm_pt_b * dp * dp)
        predicted = 0.5 * (dDd - gTdx) - 0.5 * torch.dot(r_cg, dc)

        dx = torch.cat([aux["s_cam"] * dc, (aux["s_pt"] * dp).reshape(-1)])
        return dx, predicted, iters

    return prepare, solve_step
