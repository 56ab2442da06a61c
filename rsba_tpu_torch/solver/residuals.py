"""Batched residual + Jacobian evaluation on the flat observation layout.

Counterpart of ``rsba_tpu/solver/residuals.py``.  All observations are
evaluated as one batched computation: ``torch.func.jacfwd`` over the
15 + ni tangent coordinates of a single observation, ``vmap``'d over the
observation axis.  Jacobians are taken in tangent space directly (pose ⊞ δ
on the quaternion manifold, intrinsics through the static basis).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import camera
from ..geometry import quaternion as quat
from ..problem.types import POSE_DOF, Observations, Params, Problem


class Evaluation(NamedTuple):
    """Robust-corrected, masked residuals and block Jacobians."""
    r: torch.Tensor         # (N, 2) corrected residuals
    cost: torch.Tensor      # scalar: ½ Σ mask·ρ(‖r‖²)
    J_pose: torch.Tensor    # (N, 2, 2, 6) for (pose_a, pose_b)
    J_intr: torch.Tensor    # (N, 2, ni)
    J_pt: torch.Tensor      # (N, 2, 3)

    @property
    def n_obs(self) -> int:
        return self.r.shape[0]


def gathered_residual_fn(problem: Problem):
    """Per-observation tangent-space residual closure

        f(d_pa, d_pb, d_intr, d_pt, qa, ca, qb, cb, intr, X, uv, t) → (2,)

    with the d_* tangent perturbations (pose ⊞ δ, intrinsics through the
    static basis): the function ``evaluate`` differentiates at zero."""
    model, basis = problem.model, problem.intr_basis

    def f(d_pa, d_pb, d_intr, d_pt, qa, ca, qb, cb, intr, X, uv, t):
        qa2 = quat.boxplus(qa, d_pa[:3])
        qb2 = quat.boxplus(qb, d_pb[:3])
        return camera.project(qa2, ca + d_pa[3:], qb2, cb + d_pb[3:],
                              intr + basis @ d_intr, X + d_pt, t,
                              model) - uv

    return f


def _gather(params: Params, obs: Observations):
    pa, pb = obs.pose_a.long(), obs.pose_b.long()
    return (params.q[pa], params.c[pa], params.q[pb], params.c[pb],
            params.intr[obs.intr_idx.long()], params.points[obs.point.long()])


def residuals_raw(params: Params, problem: Problem) -> torch.Tensor:
    """(N, 2) uncorrected, unmasked reprojection residuals."""
    obs = problem.obs
    qa, ca, qb, cb, intr, X = _gather(params, obs)
    return camera.project(qa, ca, qb, cb, intr, X, obs.t,
                          problem.model) - obs.uv


def rho_obs(params: Params, problem: Problem) -> torch.Tensor:
    """(N,) robust cost ρ(‖r‖²) per observation, 0 on padding."""
    r = residuals_raw(params, problem)
    rho, _, _ = problem.loss.evaluate(torch.sum(r * r, dim=-1))
    return torch.where(problem.obs.mask > 0, rho, 0.0)


def cost_only(params: Params, problem: Problem) -> torch.Tensor:
    """Robustified total cost ½ Σ mask·ρ(‖r‖²): the accept/reject metric."""
    return 0.5 * torch.sum(rho_obs(params, problem))


def cost_decrease(params_old: Params, params_new: Params,
                  problem: Problem) -> torch.Tensor:
    """½ Σ mask·(ρ_old − ρ_new), differenced per observation before the
    sum, which keeps a near-convergence decrease above float32 round-off
    of the total cost."""
    return 0.5 * torch.sum(rho_obs(params_old, problem)
                           - rho_obs(params_new, problem))


def cost_decrease_pair(rho_ref: torch.Tensor, cand: Params,
                       problem: Problem):
    """(½ Σ (ρ_ref − ρ_new), ρ_new): one residual pass on the candidate;
    ``rho_ref`` is ``rho_obs`` of the current parameters."""
    rho_new = rho_obs(cand, problem)
    return 0.5 * torch.sum(rho_ref - rho_new), rho_new


def error_stats(params: Params, problem: Problem, inlier_threshold: float):
    """(Σ‖r‖², n, Σ_inlier‖r‖², n_inlier) over valid observations.
    Inlier: ‖r‖ ≤ inlier_threshold (px)."""
    r = residuals_raw(params, problem)
    m = problem.obs.mask
    s = torch.where(m > 0, torch.sum(r * r, dim=-1), 0.0)
    inl = m * (s <= inlier_threshold * inlier_threshold)
    return torch.sum(s), torch.sum(m), torch.sum(inl * s), torch.sum(inl)


def evaluate(params: Params, problem: Problem) -> Evaluation:
    """Corrected residuals and block Jacobians for all observations.

    Masking: the padding mask selects r and J (padding may project to
    NaN), and the free masks zero the Jacobian columns of constant
    parameter blocks.
    """
    obs = problem.obs
    ni = problem.intr_tangent_dim
    dtype, dev = params.dtype, params.device
    res = gathered_residual_fn(problem)

    def f(*args):
        r = res(*args)
        return r, r

    zeros = tuple(torch.zeros(n, dtype=dtype, device=dev)
                  for n in (POSE_DOF, POSE_DOF, ni, 3))

    # With fixed intrinsics there is no intrinsics tangent to take.
    argnums = (0, 1, 2, 3) if ni > 0 else (0, 1, 3)

    def one(qa, ca, qb, cb, intr, X, uv, t):
        J, r = torch.func.jacfwd(f, argnums=argnums, has_aux=True)(
            *zeros, qa, ca, qb, cb, intr, X, uv, t)
        return r, torch.cat(J, dim=-1)

    r, J = torch.func.vmap(one)(*_gather(params, obs), obs.uv, obs.t)
    rt, Jt, rho = problem.loss.correct(r, J)
    valid = obs.mask > 0
    cost = 0.5 * torch.sum(torch.where(valid, rho, 0.0))
    rt = torch.where(valid[:, None], rt, 0.0)
    Jt = torch.where(valid[:, None, None], Jt, 0.0)
    J_pa, J_pb, J_intr, J_pt = torch.split(Jt, [POSE_DOF, POSE_DOF, ni, 3],
                                           dim=-1)
    J_pa = J_pa * problem.pose_free[obs.pose_a.long()][:, None, None]
    J_pb = J_pb * problem.pose_free[obs.pose_b.long()][:, None, None]
    if ni > 0:
        J_intr = J_intr * problem.intr_free[obs.intr_idx.long()][:, None,
                                                                 None]
    J_pt = J_pt * problem.point_free[obs.point.long()][:, None, None]
    return Evaluation(r=rt, cost=cost,
                      J_pose=torch.stack([J_pa, J_pb], dim=2),
                      J_intr=J_intr, J_pt=J_pt)


def apply_tangent(params: Params, problem: Problem, d_pose: torch.Tensor,
                  d_intr: torch.Tensor, d_pt: torch.Tensor) -> Params:
    """Retract a tangent step onto the parameters (free blocks only).
    d_pose (P, 6), d_intr (K, ni), d_pt (M, 3)."""
    d_pose = d_pose * problem.pose_free[:, None]
    d_pt = d_pt * problem.point_free[:, None]
    if problem.intr_tangent_dim > 0:
        intr = params.intr + (d_intr * problem.intr_free[:, None]
                              ) @ problem.intr_basis.T
    else:
        intr = params.intr
    return Params(q=quat.boxplus(params.q, d_pose[:, :3]),
                  c=params.c + d_pose[:, 3:], intr=intr,
                  points=params.points + d_pt)
