"""Iterative Schur solver: preconditioned conjugate gradients on the
reduced camera system.

Counterpart of ``rsba_tpu/solver/pcg.py``.  ``pcg`` is the loop the flat
``iterative_schur`` engine runs, and the banded engine under
``cluster_jacobi``; the banded engine's block-Jacobi PCG is one kernel
(``kernels/band_pcg.py``), whose plain version repeats this loop.  The flat
engine never materialises S = B_λ − E C_λ⁻¹ Eᵀ: ``SchurFreeOperator``
applies it as five batched products over the observation axis, with
gathers and fixed-order segmented sums (``flatplan.GroupPlan``).  The
gathers read through ``ObsIndex``, the observation axis's index tensors
as int64, made once per engine: a pass builds no index tensor.

The loop state of ``pcg`` lives in tensors and no scalar is read back
inside it, so a whole solve step can be captured in a CUDA graph.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..problem.types import POSE_DOF, Params, Problem
from ..utils import trace
from . import assembly, flatplan, residuals
from .options import SolverOptions
from .residuals import Evaluation
from .schur import (_lm_scaled_damp, invert_3x3_psd, jacobi_scales,
                    scale_evaluation, scaled_gradient_max)


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

# Products of millions of tiny blocks are broadcast multiplies and sums:
# ``einsum`` routes them through ``bmm``, whose batched GEMV cuBLAS runs in
# launches of at most 65,535 matrices, about ten times slower at five
# million observations on the H100.

def _bmv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A·x for a batch: (…, r, w), (…, w) → (…, r)."""
    return (A * x.unsqueeze(-2)).sum(-1)


def _bmtv(A: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Aᵀ·u for a batch: (…, r, w), (…, r) → (…, w)."""
    return (A * u.unsqueeze(-1)).sum(-2)


def _bmtm(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Aᵀ·B for a batch: (…, r, w), (…, r, v) → (…, w, v), summed over
    the r rows in order."""
    out = A[..., 0, :, None] * B[..., 0, None, :]
    for k in range(1, A.shape[-2]):
        out = out + A[..., k, :, None] * B[..., k, None, :]
    return out


class ObsIndex(NamedTuple):
    """The observation axis's index tensors as the operator gathers by
    them, int64, made once per problem: for each camera-side Jacobian
    (pose_a, pose_b under rolling shutter, the intrinsics where they have
    a tangent) the span of its blocks in the camera tangent vector, the
    block width and the block of each observation (N,); and the point of
    each observation (N,)."""
    cam: tuple                # ((start, end, width, block (N,)), ...)
    point: torch.Tensor       # (N,)


def obs_index(problem: Problem, shapes: assembly.TangentShapes) -> ObsIndex:
    obs = problem.obs
    p6 = shapes.n_poses * POSE_DOF
    cam = [(0, p6, POSE_DOF, obs.pose_a.long())]
    if problem.model.rolling_shutter:
        cam.append((0, p6, POSE_DOF, obs.pose_b.long()))
    if shapes.ni > 0:
        cam.append((p6, shapes.cam_dim, shapes.ni, obs.intr_idx.long()))
    return ObsIndex(cam=tuple(cam), point=obs.point.long())


class SchurFreeOperator(NamedTuple):
    """Matrix-free damped reduced camera system S_λ = B_λ − E C_λ⁻¹ Eᵀ."""
    ev: Evaluation
    problem: Problem
    shapes: assembly.TangentShapes
    lm_cam: torch.Tensor      # (Dc,) LM diagonal for the camera block
    C_inv: torch.Tensor       # (M, 3, 3) damped point-block inverses
    plans: flatplan.FlatPlans
    index: ObsIndex

    def _cam_jacobians(self) -> list:
        """The camera-side Jacobians (N, 2, w) in ``index.cam``'s order."""
        J = [self.ev.J_pose[:, :, 0, :]]
        if self.problem.model.rolling_shutter:
            J.append(self.ev.J_pose[:, :, 1, :])
        if self.shapes.ni > 0:
            J.append(self.ev.J_intr)
        return J

    def _jcam_apply(self, p: torch.Tensor) -> torch.Tensor:
        """u = J_cam · p over all observations → (N, 2)."""
        u = torch.zeros_like(self.ev.r)
        for J, (start, end, w, block) in zip(self._cam_jacobians(),
                                             self.index.cam):
            u = u + _bmv(J, p[start:end].view(-1, w).index_select(0,
                                                                   block))
        return u

    def _jcam_transpose_apply(self, u: torch.Tensor) -> torch.Tensor:
        """J_camᵀ · u reduced into the camera tangent vector → (Dc,)."""
        return assembly.camera_reduce(
            self.ev, self.problem, self.shapes, self.plans,
            lambda J: _bmtv(J, u))

    def _pt_reduce(self, u: torch.Tensor) -> torch.Tensor:
        """Σ_obs J_ptᵀ u per point → (M, 3)."""
        return self.plans.point.reduce(_bmtv(self.ev.J_pt, u))

    def _jpt_apply(self, y: torch.Tensor) -> torch.Tensor:
        """J_pt · y[point] over all observations → (N, 2)."""
        return _bmv(self.ev.J_pt, y.index_select(0, self.index.point))

    def et_apply(self, p: torch.Tensor) -> torch.Tensor:
        """Eᵀ·p = Σ_obs J_ptᵀ (J_cam p) per point → (M, 3)."""
        return self._pt_reduce(self._jcam_apply(p))

    def e_apply(self, y: torch.Tensor) -> torch.Tensor:
        """E·y = J_camᵀ (J_pt · y[point]) → (Dc,)."""
        return self._jcam_transpose_apply(self._jpt_apply(y))

    def matvec(self, p: torch.Tensor) -> torch.Tensor:
        """q = S_λ · p in one pass: B p − E C_λ⁻¹ Eᵀ p = J_camᵀ (u − v) with
        u = J_cam p and v = J_pt C_λ⁻¹ Eᵀ p per observation, so that the
        camera side is reduced once."""
        u = self._jcam_apply(p)
        v = self._jpt_apply(_bmv(self.C_inv, self._pt_reduce(u)))
        return self._jcam_transpose_apply(u - v) + self.lm_cam * p

    def back_substitute(self, dc: torch.Tensor, g_pt: torch.Tensor):
        """dp = C_λ⁻¹ (−g_pt − Eᵀ dc): landmark recovery."""
        return _bmv(self.C_inv, -g_pt - self.et_apply(dc))


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
        f = _bmtm(J, ev.J_pt)                             # F = J_camᵀ J_pt
        fcf = _bmtm(_bmtm(f.transpose(-1, -2), Ci).transpose(-1, -2),
                    f.transpose(-1, -2))                  # F C⁻¹ Fᵀ
        return plan.reduce(_bmtm(J, J) - fcf)

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

    Device spans (``utils/trace.py``, in a graph captured while tracing):
    ``evaluate`` (the Jacobians, diag(J̃ᵀJ̃) and the Jacobi scaling) in
    ``prepare``; ``reduced_system`` (the damping, C_λ⁻¹, the
    preconditioner's blocks and factors and the reduced rhs) and ``pcg``
    (the preconditioned CG loop and the back-substitution) in
    ``solve_step``.
    """
    shapes = assembly.static_shapes(problem)
    # The matrix-free operator reduces by pose, intrinsics and point
    # alone: no pair plan.
    plans = flatplan.build_flat_plans(problem, pairs=False)
    index = obs_index(problem, shapes)
    cluster_plan = None
    if options.preconditioner == "cluster_jacobi":
        from . import cluster as cluster_mod
        cluster_plan = cluster_mod.build_cluster_plan(problem, plans.point)

    def prepare(params: Params):
        # The Jacobi scales read diag(J̃ᵀJ̃), so its reduction is timed
        # with the evaluation it scales.
        with trace.device_span("evaluate"):
            ev = residuals.evaluate(params, problem)
            d_cam, C_diag = assembly.jtj_diag(ev, problem, shapes, plans)
            s_cam, s_pt = jacobi_scales(d_cam, C_diag, options)
            ev = scale_evaluation(ev, problem, shapes, s_cam,
                                  s_pt.reshape(-1))
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

        with trace.device_span("reduced_system"):
            lm_cam, _ = _lm_scaled_damp(aux["d_cam"], radius, options)
            c_diag = torch.diagonal(C, dim1=-2, dim2=-1).reshape(-1)
            lm_pt, _ = _lm_scaled_damp(c_diag, radius, options)
            lm_pt_b = lm_pt.reshape(M, 3)
            C_inv = invert_3x3_psd(C + torch.diag_embed(lm_pt_b))

            op = SchurFreeOperator(ev=ev, problem=problem, shapes=shapes,
                                   lm_cam=lm_cam, C_inv=C_inv, plans=plans,
                                   index=index)
            D_pose, D_intr = schur_jacobi_blocks(ev, problem, shapes,
                                                 lm_cam, C_inv, plans)
            # Reduced rhs: b = −g_cam − E C_λ⁻¹ (−g_pt).
            b = -g_cam - op.e_apply(_bmv(C_inv, -g_pt))

            if cluster_plan is not None:
                from . import cluster as cluster_mod
                precond = cluster_mod.make_cluster_preconditioner(
                    cluster_plan, D_pose, D_intr, shapes, ev, problem,
                    C_inv)
            elif options.preconditioner == "schur_jacobi":
                precond = make_block_preconditioner(D_pose, D_intr, shapes)
            else:
                def precond(r):
                    return _jacobi_apply(D_pose, D_intr, shapes, r)

        with trace.device_span("pcg"):
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
