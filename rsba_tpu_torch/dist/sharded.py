"""Flat sharded solver: ``iterative_schur`` and ``dense_schur`` over ranks
that each own a chunk of the landmarks.

Counterpart of ``rsba_tpu/dist/sharded.py``, on the port's flat engines
(``solver/pcg.py``, ``solver/schur.py``) and their host-built groupings
(``solver/flatplan.py``), localised to the rank's observations:

* Each rank owns a contiguous chunk of ``m_local`` landmarks and all
  observations of them (``dist.partition`` layout), so landmark
  elimination (C blocks, C⁻¹, back-substitution) is local.
* Poses and intrinsics are whole on every rank; their gradient,
  JᵀJ diagonal and Schur-complement parts are summed with ``all_reduce``.
  The PCG matvec costs one all-reduce of a (Dc,) vector, so
  ``iterative_schur`` makes one per CG pass (``pcg`` always makes
  ``max_cg_iterations`` passes, so every rank makes the same calls);
  ``dense_schur`` all-reduces the (Dc, Dc) reduced system once a step.
* The preconditioner is Schur-Jacobi for ``"schur_jacobi"`` and the
  plain Jacobi diagonal for any other choice, as in the reference.
* Trust-region state is replicated: ``lm.solve``'s host loop takes the
  same decision on every rank.
"""
from __future__ import annotations

from functools import partial

import torch

from ..problem.types import POSE_DOF, Params, Problem
from ..solver import assembly, flatplan, residuals
from ..solver.lm import inlier_threshold
from ..solver.options import SolverOptions
from ..solver.pcg import (SchurFreeOperator, _jacobi_apply, add_lm_diag,
                          make_block_preconditioner, pcg,
                          schur_jacobi_partial)
from ..solver.schur import (_lm_scaled_damp, assemble_B, assemble_E,
                            gn_hessian_apply, invert_3x3_psd, jacobi_scales,
                            scale_evaluation, scaled_gradient_max)
from . import mesh as mesh_mod
from .mesh import Mesh


def make_sharded_solver_fns(problem: Problem, options: SolverOptions,
                            mesh: Mesh) -> dict:
    """``lm.solve`` phase functions of ``options.linear_solver``
    (``iterative_schur`` or ``dense_schur``) over this rank's chunk.

    ``problem`` is the whole problem in the ``repartition_by_point``
    layout, on any device; the rank's block goes to ``mesh.device``.
    External parameters are whole on every rank (``to_internal`` /
    ``to_external``); internal ones hold the rank's chunk of points.
    """
    if options.linear_solver not in ("iterative_schur", "dense_schur"):
        raise ValueError(f"the flat sharded solver runs iterative_schur or "
                         f"dense_schur, not {options.linear_solver}")
    use_pcg = options.linear_solver == "iterative_schur"
    block = mesh_mod.shard_problem(problem, mesh)
    m_local = int(block.point_free.shape[0])
    # Global → rank-local point indices.
    prob = block.replace(obs=block.obs.replace(
        point=block.obs.point - mesh.rank * m_local))
    shapes = assembly.static_shapes(prob)
    plans = flatplan.build_flat_plans(prob, pairs=not use_pcg)
    p6 = shapes.n_poses * POSE_DOF
    thresh = inlier_threshold(problem)

    # --- prepare: evaluate + assemble ----------------------------------------

    def prepare(params: Params) -> dict:
        ev = residuals.evaluate(params, prob)
        d_cam, C_diag = assembly.jtj_diag(ev, prob, shapes, plans)
        cost, d_cam = mesh.psum(ev.cost, d_cam)
        s_cam, s_pt = jacobi_scales(d_cam, C_diag, options)
        ev = scale_evaluation(ev, prob, shapes, s_cam,
                              s_pt.reshape(-1))._replace(cost=cost)
        g_pose, g_intr, g_pt = assembly.gradient_blocks(ev, prob, shapes,
                                                        plans)
        parts = [torch.cat([g_pose.reshape(-1), g_intr.reshape(-1)]),
                 assembly.jtj_diag(ev, prob, shapes, plans)[0]]
        if not use_pcg:
            parts.append(assemble_B(ev, prob, shapes, plans))
        parts = mesh.psum(*parts)
        g_cam = parts[0]
        aux = {"cost": cost, "ev": ev, "g_cam": g_cam, "g_pt": g_pt,
               "C": assembly.point_hessian_blocks(ev, plans),
               "d_cam": parts[1], "s_cam": s_cam, "s_pt": s_pt,
               # g_cam is whole on every rank: the max over the ranks of
               # each one's max is the whole gradient's
               "gradient_max_norm": mesh.pmax(
                   scaled_gradient_max(g_cam, s_cam, g_pt, s_pt))}
        if not use_pcg:
            aux["B"] = parts[2]
            aux["A"] = assemble_E(ev, prob, shapes, plans)
        return aux

    # --- solve_step: damped Schur solve --------------------------------------

    def damped_point_blocks(C, radius):
        c_diag = torch.diagonal(C, dim1=-2, dim2=-1).reshape(-1)
        lm_pt, _ = _lm_scaled_damp(c_diag, radius, options)
        lm_pt = lm_pt.reshape(m_local, 3)
        return invert_3x3_psd(C + torch.diag_embed(lm_pt)), lm_pt

    def finish(aux, dc, dp, lm_cam, lm_pt):
        """Predicted decrease (without a CG residual term) and the
        unscaled step."""
        # lm_pt > 0, so a non-finite dp on any rank makes dDd and the
        # predicted decrease non-finite on every rank: all of them reject
        # the step alike.
        gTdp, dDd_pt = mesh.psum(torch.sum(aux["g_pt"] * dp),
                                 torch.sum(lm_pt * dp * dp))
        gTdx = torch.dot(aux["g_cam"], dc) + gTdp
        dDd = torch.sum(lm_cam * dc * dc) + dDd_pt
        dx_cam = aux["s_cam"] * dc
        step = {"pose": dx_cam[:p6].reshape(shapes.n_poses, POSE_DOF),
                "intr": dx_cam[p6:].reshape(shapes.n_intr, shapes.ni),
                "pt": aux["s_pt"] * dp}
        return step, 0.5 * (dDd - gTdx)

    def solve_step_pcg(aux, radius):
        ev, g_cam, g_pt = aux["ev"], aux["g_cam"], aux["g_pt"]
        lm_cam, _ = _lm_scaled_damp(aux["d_cam"], radius, options)
        C_inv, lm_pt = damped_point_blocks(aux["C"], radius)
        # The operator without the LM diagonal gives this rank's part of
        # (B − E C⁻¹ Eᵀ)·p; the diagonal is added once, after the sum.
        op = SchurFreeOperator(ev=ev, problem=prob, shapes=shapes,
                               lm_cam=torch.zeros_like(lm_cam), C_inv=C_inv,
                               plans=plans)
        b = -g_cam - mesh.psum(
            op.e_apply(torch.einsum("mab,mb->ma", C_inv, -g_pt)))[0]

        def matvec(p):
            return mesh.psum(op.matvec(p))[0] + lm_cam * p

        D_pose, D_intr = mesh.psum(*schur_jacobi_partial(
            ev, prob, shapes, C_inv, plans))
        D_pose, D_intr = add_lm_diag(D_pose, D_intr, lm_cam, shapes)
        precond = (make_block_preconditioner(D_pose, D_intr, shapes)
                   if options.preconditioner == "schur_jacobi"
                   else partial(_jacobi_apply, D_pose, D_intr, shapes))
        dc, r_cg, iters = pcg(matvec, precond, b, options.max_cg_iterations,
                              options.cg_eta)
        dp = op.back_substitute(dc, g_pt)
        step, predicted = finish(aux, dc, dp, lm_cam, lm_pt)
        return step, predicted - 0.5 * torch.dot(r_cg, dc), iters

    def solve_step_dense(aux, radius):
        ev, g_cam, g_pt = aux["ev"], aux["g_cam"], aux["g_pt"]
        B, A = aux["B"], aux["A"]
        Dc = shapes.cam_dim
        lm_cam, _ = _lm_scaled_damp(aux["d_cam"], radius, options)
        C_inv, lm_pt = damped_point_blocks(aux["C"], radius)
        # Reduced system: the ranks' elimination terms summed, then the
        # same Cholesky on every rank (Dc is small next to M).
        Y = torch.einsum("mab,mbd->mad", C_inv, A)
        S = B + torch.diag(lm_cam) - mesh.psum(
            A.reshape(-1, Dc).T @ Y.reshape(-1, Dc))[0]
        L, _ = torch.linalg.cholesky_ex(S, check_errors=False)

        def schur_solve(rc, rp):
            w = torch.einsum("mab,mb->ma", C_inv, rp)
            rhs = rc - mesh.psum(torch.einsum("mad,ma->d", A, w))[0]
            dc = torch.cholesky_solve(rhs[:, None], L)[:, 0]
            dp = torch.einsum("mab,mb->ma", C_inv,
                              rp - torch.einsum("mad,d->ma", A, dc))
            return dc, dp

        dc, dp = schur_solve(-g_cam, -g_pt)
        for _ in range(options.refinement_steps):
            Hx_cam, Hx_pt = gn_hessian_apply(ev, prob, shapes, plans, dc, dp)
            cc, cp = schur_solve(
                -g_cam - (mesh.psum(Hx_cam)[0] + lm_cam * dc),
                -g_pt - (Hx_pt + lm_pt * dp))
            dc = dc + cc
            dp = dp + cp
        step, predicted = finish(aux, dc, dp, lm_cam, lm_pt)
        return step, predicted, torch.zeros((), dtype=torch.int32,
                                            device=dc.device)

    # --- apply / cost / stats ------------------------------------------------

    def apply_step(params: Params, step: dict):
        new = residuals.apply_tangent(params, prob, step["pose"],
                                      step["intr"], step["pt"])
        pt_sn2, pt_xn2 = mesh.psum(torch.sum(step["pt"] ** 2),
                                   torch.sum(params.points ** 2))
        sn2 = torch.sum(step["pose"] ** 2) + torch.sum(step["intr"] ** 2) \
            + pt_sn2
        xn2 = (torch.sum(params.q ** 2) + torch.sum(params.c ** 2)
               + torch.sum(params.intr ** 2) + pt_xn2)
        return new, torch.sqrt(sn2), torch.sqrt(xn2)

    def to_external(params: Params) -> Params:
        # The ranks' chunks placed in zeros and summed: exact.
        pts = params.points.new_zeros((mesh.size * m_local, 3))
        pts[mesh.rank * m_local:(mesh.rank + 1) * m_local] = params.points
        return params.replace(points=mesh.psum(pts)[0])

    return {
        "prepare": prepare,
        "solve_step": solve_step_pcg if use_pcg else solve_step_dense,
        "apply_step": apply_step,
        "cost": lambda p: mesh.psum(residuals.cost_only(p, prob))[0],
        "cost_decrease": lambda a, b: mesh.psum(
            residuals.cost_decrease(a, b, prob))[0],
        "error_stats": lambda p: mesh.psum(
            *residuals.error_stats(p, prob, thresh)),
        "to_internal": lambda p: mesh_mod.shard_params(p, mesh),
        "to_external": to_external,
        "engine": (options.linear_solver, "torch-flat-sharded"),
    }
