"""Gradient / normal-equation assembly from batched block Jacobians.

Counterpart of ``rsba_tpu/solver/assembly.py``.  Reductions over the
observation axis are fixed-order segmented sums through the groupings of
``flatplan``.

Tangent vector layout (flat): ``[poses (P·6) | intrinsics (K·ni) | points
(M·3)]``.  The camera part (poses + intrinsics) is the Schur "camera"
group; points are the eliminated group.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..problem.types import POSE_DOF, Params, Problem
from .flatplan import FlatPlans
from .residuals import Evaluation


class TangentShapes(NamedTuple):
    n_poses: int
    n_intr: int
    ni: int
    n_points: int

    @property
    def cam_dim(self) -> int:
        return self.n_poses * POSE_DOF + self.n_intr * self.ni

    @property
    def point_dim(self) -> int:
        return self.n_points * 3

    @property
    def total_dim(self) -> int:
        return self.cam_dim + self.point_dim


def tangent_shapes(problem: Problem, params: Params) -> TangentShapes:
    return TangentShapes(params.n_poses, params.intr.shape[0],
                         problem.intr_tangent_dim, params.n_points)


def static_shapes(problem: Problem) -> TangentShapes:
    """The tangent shapes from the problem alone."""
    return TangentShapes(
        int(problem.pose_free.shape[0]), int(problem.intr_free.shape[0]),
        problem.intr_tangent_dim, int(problem.point_free.shape[0]))


def unflatten_tangent(x: torch.Tensor, shapes: TangentShapes):
    """Flat tangent vector → (d_pose (P, 6), d_intr (K, ni), d_pt (M, 3))."""
    p6 = shapes.n_poses * POSE_DOF
    kni = shapes.n_intr * shapes.ni
    return (x[:p6].reshape(shapes.n_poses, POSE_DOF),
            x[p6:p6 + kni].reshape(shapes.n_intr, shapes.ni),
            x[p6 + kni:].reshape(shapes.n_points, 3))


def flatten_tangent(d_pose, d_intr, d_pt) -> torch.Tensor:
    return torch.cat([d_pose.reshape(-1), d_intr.reshape(-1),
                      d_pt.reshape(-1)])


def camera_blocks(ev: Evaluation, problem: Problem, shapes: TangentShapes,
                  plans: FlatPlans, per_obs):
    """Reduce ``per_obs(J) → (N, w, ...)`` of each camera-side Jacobian
    into per-pose (P, 6, ...) and per-intrinsics (K, ni, ...) blocks."""
    pose = plans.pose_a.reduce(per_obs(ev.J_pose[:, :, 0, :]))
    if problem.model.rolling_shutter:
        pose = pose + plans.pose_b.reduce(per_obs(ev.J_pose[:, :, 1, :]))
    if shapes.ni > 0:
        intr = plans.intr.reduce(per_obs(ev.J_intr))
    else:
        intr = ev.r.new_zeros((shapes.n_intr, 0) + tuple(pose.shape[2:]))
    return pose, intr


def camera_reduce(ev, problem, shapes, plans, per_obs) -> torch.Tensor:
    """``camera_blocks`` of per-observation (N, w) values, flattened to the
    camera tangent vector (Dc,)."""
    pose, intr = camera_blocks(ev, problem, shapes, plans, per_obs)
    return torch.cat([pose.reshape(-1), intr.reshape(-1)])


def gradient_blocks(ev: Evaluation, problem: Problem, shapes: TangentShapes,
                    plans: FlatPlans):
    """g = J̃ᵀ r̃ per block: (P, 6), (K, ni), (M, 3)."""
    jtr = lambda J: torch.einsum("nrd,nr->nd", J, ev.r)  # noqa: E731
    g_pose, g_intr = camera_blocks(ev, problem, shapes, plans, jtr)
    return g_pose, g_intr, plans.point.reduce(jtr(ev.J_pt))


def point_hessian_blocks(ev: Evaluation, plans: FlatPlans) -> torch.Tensor:
    """C (M, 3, 3): per-point Gauss-Newton blocks Σ J_ptᵀ J_pt."""
    return plans.point.reduce(
        torch.einsum("nrd,nre->nde", ev.J_pt, ev.J_pt))


def jtj_diag(ev: Evaluation, problem: Problem, shapes: TangentShapes,
             plans: FlatPlans):
    """diag(J̃ᵀJ̃), for LM damping and Jacobi scaling: the camera part
    flattened (Dc,), the point part (M, 3)."""
    sq = lambda J: torch.sum(J * J, dim=1)  # noqa: E731
    return (camera_reduce(ev, problem, shapes, plans, sq),
            plans.point.reduce(sq(ev.J_pt)))


# --- dense path (small problems; cross-check for the Schur path) -------------

def dense_jacobian(ev: Evaluation, problem: Problem,
                   shapes: TangentShapes) -> torch.Tensor:
    """The full dense Jacobian (N·2, D).  Only for small problems: the
    exact oracle the Schur paths are checked against."""
    obs = problem.obs
    N, D = ev.n_obs, shapes.total_dim
    p6 = shapes.n_poses * POSE_DOF
    kni = shapes.n_intr * shapes.ni
    Jd = ev.r.new_zeros((N, 2, D))
    rows = torch.arange(N, device=ev.r.device)[:, None, None]
    rdim = torch.arange(2, device=ev.r.device)[None, :, None]

    def put(Jb, base):
        # One block's columns are distinct within an observation, so the
        # read-add-write touches each element once.
        cols = (base.long()[:, None]
                + torch.arange(Jb.shape[2], device=Jb.device))[:, None, :]
        Jd[rows, rdim, cols] = Jd[rows, rdim, cols] + Jb

    put(ev.J_pose[:, :, 0, :], obs.pose_a * POSE_DOF)
    put(ev.J_pose[:, :, 1, :], obs.pose_b * POSE_DOF)
    if shapes.ni > 0:
        put(ev.J_intr, p6 + obs.intr_idx * shapes.ni)
    put(ev.J_pt, p6 + kni + obs.point * 3)
    return Jd.reshape(N * 2, D)


def dense_normal_equations(ev: Evaluation, problem: Problem,
                           shapes: TangentShapes):
    """(H, g) fully dense: H = J̃ᵀJ̃ (D, D), g = J̃ᵀr̃ (D,)."""
    Jd = dense_jacobian(ev, problem, shapes)
    return Jd.T @ Jd, Jd.T @ ev.r.reshape(-1)
