"""Sharded banded window solver: the multi-GPU path of config 5.

Counterpart of ``rsba_tpu/dist/banded_sharded.py``.  The window grid's
row axis (NR) is split: each rank owns a contiguous block of rows, that
is a contiguous slice of the trajectory's feature tracks, with those
rows' points and observation slots.  Poses are whole on every rank.

Communication, all of it ``all_reduce`` (``Mesh.psum`` / ``pmax``):

* ``prepare``: each rank runs the fused evaluate+assemble on its rows
  (the CUDA kernel on the card, its plain version on the CPU:
  ``banded_fused.evaluate_fold``, unchanged on a block of rows) and folds
  them; cost, ``g_cam`` (P, 6) and the B band (P, 2, 6, 6) are one
  all-reduce, the gradient's max norm a second; Jacobi scaling follows
  on the whole system.  Point-side ``g_pt``, C and F stay local.
* ``solve_step``: the Schur band's point-side term F C⁻¹ Fᵀ (P, W, 6, 6)
  and the right-hand side's E C⁻¹ g_pt (P, 6) are one all-reduce; PCG
  then runs on the whole band, the same on every rank, with no
  collective; back-substitution is local, and the point terms of the
  predicted decrease are one all-reduce of two numbers.
* ``apply_step``, ``cost``, ``cost_decrease``, ``error_stats``: local
  values, then one all-reduce each.

The trust-region decisions are taken by ``lm.solve``'s host loop on every
rank from these all-reduced scalars, which are equal in every bit on
every rank.  There is no on-device loop for this engine (no ``raw``
phases): NCCL collectives under CUDA graph capture are not done yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..problem import types
from ..problem.types import Params, Problem
from ..solver import banded, banded_fused
from ..solver.options import SolverOptions
from ..solver.window import WindowPlan, build_window_plan
from .mesh import Mesh


def _slim(problem: Problem, device) -> Problem:
    """The problem with its observation arrays dropped to one row, on
    ``device``: the engine reads only the model, the loss and the free
    masks from it (the rank's rows of the window plan carry its
    observations)."""
    obs = problem.obs
    return problem.replace(
        obs=obs.replace(**{f.name: getattr(obs, f.name)[:1].to(device)
                           for f in dataclasses.fields(obs)}),
        pose_free=problem.pose_free.to(device),
        point_free=problem.point_free.to(device),
        intr_free=problem.intr_free.to(device),
        intr_basis=problem.intr_basis.to(device))


def make_sharded_window_solver_fns(problem: Problem, options: SolverOptions,
                                   mesh: Mesh,
                                   plan: WindowPlan | None = None) -> dict:
    """``lm.solve`` phase functions of the banded solver over this rank's
    block of window rows.

    ``problem`` is the whole problem, on any device (the host keeps the
    memory of the card for the rank's rows); the rank's rows of the plan
    and a one-row stub of the problem go to ``mesh.device``.  The plan is
    built with its row count padded to a multiple of lcm(8, world size)
    unless given.  Raises ValueError when the problem does not admit the
    window layout: callers fall back to ``make_sharded_solver_fns``.

    External parameters (``to_internal`` / ``to_external``) are whole on
    every rank; internal ones hold the rank's rows of points as planes.
    """
    n = mesh.size
    if plan is None:
        plan = build_window_plan(problem, nr_multiple=int(np.lcm(8, n)))
    if plan is None:
        raise ValueError(
            "problem does not admit the window layout; use the flat "
            "sharded solver (dist.make_sharded_solver_fns)")
    if plan.NR % n:
        raise ValueError(f"plan rows ({plan.NR}) not divisible by the world "
                         f"size ({n}); rebuild with nr_multiple=lcm(8, {n})")
    nr_local = plan.NR // n
    r0 = mesh.rank * nr_local
    local = plan.rows(r0, r0 + nr_local).to(mesh.device)
    prob = _slim(problem, mesh.device)
    evaluate, use_kernel = banded_fused.pick_evaluator(options, mesh.device)
    statics = banded_fused.kernel_statics(local, prob)
    from ..solver.lm import inlier_threshold
    thresh = inlier_threshold(problem)
    as_v1 = banded_fused._as_v1

    def prepare(params: Params) -> dict:
        parts = banded_fused.evaluate_fold(local, prob, params, evaluate,
                                           statics)
        parts["cost"], parts["g_cam"], parts["B0"], parts["B1"] = mesh.psum(
            parts["cost"], parts["g_cam"], parts["B0"], parts["B1"])
        gmax = mesh.pmax(torch.maximum(parts["g_cam"].abs().max(),
                                       parts["g_pt"].abs().max()))
        return banded_fused.scale_system(local, options, parts, gmax)

    def to_internal(params: Params) -> Params:
        params = types.params_from_numpy(params, device=mesh.device,
                                         dtype=params.dtype)
        return banded_fused.to_internal(params, local)

    def to_external(params: Params) -> Params:
        # Each point lies in exactly one row: the sum over the ranks of
        # their rows scattered into zeros is exact.
        pts = local.scatter_points(params.points.transpose(1, 2))
        return params.replace(points=mesh.psum(pts)[0])

    return {
        "prepare": prepare,
        "solve_step": lambda aux, radius: banded_fused.solve_step(
            local, options, aux, radius, psum=mesh.psum),
        "apply_step": lambda p, dx: banded_fused.apply_step(
            local, prob, p, dx, statics.ptf, psum=mesh.psum),
        "cost": lambda p: mesh.psum(
            banded.cost_only(local, prob, as_v1(p)))[0],
        "cost_decrease": lambda a, b: mesh.psum(banded.cost_decrease(
            local, prob, as_v1(a), as_v1(b)))[0],
        "error_stats": lambda p: mesh.psum(*banded.error_stats(
            local, prob, as_v1(p), thresh)),
        "to_internal": to_internal,
        "to_external": to_external,
        "engine": ("banded_schur",
                   ("cuda" if use_kernel else "torch") + "-sharded"),
        # this rank's block: its rows [r0, r1) of the whole plan, their
        # plan and the one-row problem the phases read
        "local": {"rows": (r0, r0 + nr_local), "plan": local,
                  "problem": prob},
    }
