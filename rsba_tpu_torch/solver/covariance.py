"""Covariance estimation — counterpart of ``rsba_tpu/solver/covariance.py``
(parity with ``ceres::Covariance``).

Gauss-Newton parameter covariances at the solution from the
robust-corrected Jacobian, through the Schur structure the solver uses:

    H = [B  E; Eᵀ C]   (camera / point blocks, no damping)
    cov(cameras) = S⁻¹            with S = B − E C⁻¹ Eᵀ
    cov(point m) = C_m⁻¹ + C_m⁻¹ E_mᵀ S⁻¹ E_m C_m⁻¹

so the only dense inverse is of the reduced camera system S (Dc × Dc);
points are recovered per point in closed form, as in the solver's
back-substitution.

Gauge handling: constant blocks (``pose_free`` / ``point_free``, for
example the gauge-fixed first camera) have zero Jacobian columns, which
would make S singular.  Their tangent diagonal is pinned to 1 for the
inverse and their covariance zeroed afterwards: they are not random
variables.  Covariance is only defined on a fully gauge-fixed problem: a
free similarity gauge (7 dof) makes H singular.  Fixing one pose removes
6 dof; pin at least one more (a second pose, or one point) before
calling, otherwise the Cholesky of S fails.

Scaling: cov(x) assumes unit-variance residuals (the Ceres convention).
Multiply by ``sigma2_estimate`` (2·cost / (n_residuals − n_params)) for
the data-driven scale.  The dense S limits this to Dc ≲ 15k (about 2.5k
poses); raise ``max_cam_dim`` to force a larger inverse.
"""
from __future__ import annotations

import dataclasses

import torch

from ..problem.types import POSE_DOF, Params, Problem
from . import assembly, flatplan, residuals
from .schur import assemble_B, assemble_E, invert_3x3_psd


@dataclasses.dataclass
class CovarianceResult:
    pose: torch.Tensor       # (P, 6, 6) per-pose tangent covariance
    point: torch.Tensor      # (M, 3, 3) per-point covariance
    cam_full: torch.Tensor   # (Dc, Dc) full camera-block covariance S⁻¹
    sigma2_estimate: float   # 2·cost / (n_res − n_params)


def compute_covariance(problem: Problem, params: Params,
                       max_cam_dim: int = 15000,
                       point_jitter: float = 0.0) -> CovarianceResult:
    """Gauss-Newton covariance at ``params`` (normally the solution), on
    the device the problem lies on.

    ``point_jitter`` adds εI to the point blocks before inversion for
    problems with weakly observed landmarks (two views at a shallow
    angle); 0 keeps the estimate exact.
    """
    shapes = assembly.tangent_shapes(problem, params)
    Dc = shapes.cam_dim
    if Dc > max_cam_dim:
        raise ValueError(
            f"camera tangent dim {Dc} exceeds max_cam_dim={max_cam_dim}; "
            "dense S⁻¹ would need "
            f"{Dc * Dc * 8 / 2**30:.1f} GiB — raise max_cam_dim to force")
    plans = flatplan.build_flat_plans(problem)
    ev = residuals.evaluate(params, problem)

    B = assemble_B(ev, problem, shapes, plans)
    A = assemble_E(ev, problem, shapes, plans)        # (M, 3, Dc) = Eᵀ rows
    C = assembly.point_hessian_blocks(ev, plans)

    # Pin constant and unobserved tangent dims to identity for the inverses.
    cam_free = problem.pose_free.repeat_interleave(POSE_DOF)
    if shapes.ni > 0:
        cam_free = torch.cat(
            [cam_free, problem.intr_free.repeat_interleave(shapes.ni)])
    B = B + torch.diag(torch.where(cam_free > 0, 0.0, 1.0).to(B.dtype))
    # A free point with fewer than two valid observations has a
    # rank-deficient 3×3 information block (one 2-D observation cannot
    # constrain depth): pin it like a constant block and zero it out.
    # The per-point count is a fixed-order segmented sum.
    n_obs_per_pt = plans.point.reduce(problem.obs.mask)
    pt_free = problem.point_free * (n_obs_per_pt >= 2).to(C.dtype)
    eye3 = torch.eye(3, dtype=C.dtype, device=C.device)
    # Pinning = conditioning on the pinned blocks: zero their coupling and
    # information, identity on their diagonal (the inverse of the free
    # submatrix then equals the full inverse restricted to the free dims).
    A = A * pt_free[:, None, None]
    C = (C * pt_free[:, None, None]
         + torch.where(pt_free > 0, point_jitter, 1.0)[:, None, None] * eye3)

    C_inv = invert_3x3_psd(C)
    Y = torch.einsum("mab,mbd->mad", C_inv, A)        # C⁻¹Eᵀ  (M, 3, Dc)
    M3 = shapes.n_points * 3
    S = B - A.reshape(M3, Dc).T @ Y.reshape(M3, Dc)

    # S⁻¹ through Cholesky (S is positive definite after gauge pinning).
    L = torch.linalg.cholesky(S)
    Si = torch.cholesky_solve(torch.eye(Dc, dtype=S.dtype, device=S.device),
                              L)

    # Per-point covariance: C⁻¹ + (C⁻¹Eᵀ) S⁻¹ (C⁻¹Eᵀ)ᵀ.
    pt_cov = C_inv + torch.einsum("mad,mbd->mab", Y @ Si, Y)

    # Zero out constant blocks.
    Si = Si * (cam_free[:, None] * cam_free[None, :])
    pt_cov = pt_cov * pt_free[:, None, None]

    P = shapes.n_poses
    ar = torch.arange(P, device=Si.device)
    pose_cov = Si[:P * POSE_DOF, :P * POSE_DOF].reshape(
        P, POSE_DOF, P, POSE_DOF)[ar, :, ar, :]

    n_res, n_par, cost = torch.stack([
        2.0 * torch.sum(problem.obs.mask),
        torch.sum(cam_free) + 3.0 * torch.sum(pt_free),
        residuals.cost_only(params, problem)]).tolist()
    sigma2 = 2.0 * cost / max(n_res - n_par, 1.0)
    return CovarianceResult(pose=pose_cov, point=pt_cov, cam_full=Si,
                            sigma2_estimate=sigma2)
