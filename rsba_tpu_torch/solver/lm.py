"""Levenberg–Marquardt trust-region loop.

Counterpart of ``rsba_tpu/solver/lm.py``: Ceres ``TrustRegionMinimizer``
+ ``LevenbergMarquardtStrategy`` semantics — damping λ = 1/μ, step
acceptance by relative decrease ρ, Ceres's radius update rules and the
same convergence tests (gradient / function / parameter tolerance).

``solve`` runs the on-device loop (``lm_device.py``) when the engine
exposes raw phase closures and ``device_loop`` is not "off", else the
host loop below, which calls the phase functions in turn (prepare,
solve_step, apply_step, cost_decrease) and reads scalars back.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional, Tuple

import torch

from ..problem.types import Params, Problem
from ..utils import trace
from . import assembly, residuals
from .options import SolverOptions
from .summary import IterationSummary, Summary


def _rmse(sq_px_sum, n_valid) -> float:
    return math.sqrt(float(sq_px_sum) / max(float(n_valid), 1.0))


def inlier_threshold(problem: Problem) -> float:
    """Inlier gate for RMSE reporting: 3× the robust-loss scale (px); no
    gate (inf) for non-robust problems."""
    if problem.loss.kind == "trivial":
        return float("inf")
    return 3.0 * problem.loss.scale


def make_solver_fns(problem: Problem, options: SolverOptions) -> dict:
    """Phase functions for a problem.

    ``linear_solver="auto"`` picks the banded window solver
    (``banded_fused``) when the problem's track structure admits it and
    falls back to ``iterative_schur`` on the flat layout otherwise;
    "banded_schur" requires the window layout and raises if it does not
    apply.  ``fns["engine"]`` records the resolved (linear_solver,
    evaluator) pair, which the Summary carries.
    """
    with trace.span("plan"):
        return _make_solver_fns(problem, options)


def _make_solver_fns(problem: Problem, options: SolverOptions) -> dict:
    if options.trust_region_strategy == "dogleg":
        # Dogleg needs an exact step solver; the factory validates
        # linear_solver and wraps the base engine.
        from .dogleg import make_dogleg_solver
        prepare, solve_step = make_dogleg_solver(problem, options)
        return _flat_fns(problem, options, prepare, solve_step,
                         engine=(options.linear_solver, "torch-flat-dogleg"))
    if options.linear_solver in ("auto", "banded_schur"):
        from .window import build_window_plan
        with trace.span("plan.window", device=str(problem.device),
                        host_bytes=0) as sp:
            plan = build_window_plan(problem)
            if plan is not None:
                sp.set(NR=plan.NR, W=plan.W, L=plan.L, G=plan.G)
        if plan is not None:
            from .banded_fused import make_fused_solver_fns
            with trace.span("plan.engine"):
                return make_fused_solver_fns(problem, plan, options)
        if options.linear_solver == "banded_schur":
            raise ValueError(
                "banded_schur requires window/track structure (bounded "
                "pose spans, pose_b ∈ {pose_a, pose_a+1}, single fixed "
                "intrinsics block); use linear_solver='auto' to fall back")
        options = dataclasses.replace(options,
                                      linear_solver="iterative_schur")
    with trace.span("plan.engine") as sp:
        if options.linear_solver == "dense":
            from .dense import make_dense_solver
            prepare, solve_step = make_dense_solver(problem, options)
        elif options.linear_solver == "dense_schur":
            from .schur import make_dense_schur_solver
            prepare, solve_step = make_dense_schur_solver(problem, options)
        elif options.linear_solver == "iterative_schur":
            from .pcg import make_iterative_schur_solver
            prepare, solve_step = make_iterative_schur_solver(problem,
                                                              options)
        else:
            raise ValueError(options.linear_solver)
        if trace.enabled():
            sp.set(**_flat_sizes(problem, options.linear_solver))
    return _flat_fns(problem, options, prepare, solve_step,
                     engine=(options.linear_solver, "torch-flat"))


def _flat_sizes(problem: Problem, linear_solver: str) -> dict:
    """What a flat engine works on, for its ``plan.engine`` span: the
    camera tangent's size ``Dc``, the points ``M``, the distinct
    camera–point ``pairs`` of the valid observations (a camera is a pose:
    pose_a, and pose_b under rolling shutter), and ``e_bytes``, the bytes
    of the dense Eᵀ (M, 3, Dc) that ``dense_schur`` holds (0 for the
    engines that hold none)."""
    shapes = assembly.static_shapes(problem)
    obs = problem.obs
    valid = obs.mask > 0
    point = obs.point[valid].long() * shapes.n_poses
    poses = (obs.pose_a, obs.pose_b) if problem.model.rolling_shutter \
        else (obs.pose_a,)
    pairs = torch.unique(torch.cat([point + p[valid].long() for p in poses]))
    e_bytes = (shapes.n_points * 3 * shapes.cam_dim
               * obs.uv.element_size()) if linear_solver == "dense_schur" \
        else 0
    return {"Dc": shapes.cam_dim, "M": shapes.n_points,
            "pairs": int(pairs.numel()), "e_bytes": e_bytes}


def _flat_fns(problem: Problem, options: SolverOptions, prepare, solve_step,
              engine) -> dict:
    """Shared phase-fn dict for the flat-layout engines (dense /
    dense_schur / iterative_schur / dogleg): retraction, cost, stats."""
    shapes = assembly.static_shapes(problem)
    thresh = inlier_threshold(problem)

    def apply_step(params: Params, dx: torch.Tensor):
        d_pose, d_intr, d_pt = assembly.unflatten_tangent(dx, shapes)
        new_params = residuals.apply_tangent(params, problem, d_pose, d_intr,
                                             d_pt)
        x_norm = torch.sqrt(
            torch.sum(params.c ** 2) + torch.sum(params.points ** 2)
            + torch.sum(params.q ** 2) + torch.sum(params.intr ** 2))
        return new_params, torch.linalg.vector_norm(dx), x_norm

    fns = {
        "prepare": prepare,
        "solve_step": solve_step,
        "apply_step": apply_step,
        "cost": lambda p: residuals.cost_only(p, problem),
        "cost_decrease": lambda a, b: residuals.cost_decrease(a, b, problem),
        "error_stats": lambda p: residuals.error_stats(p, problem, thresh),
        "engine": engine,
    }
    # Raw phase closures: the on-device loop (lm_device.py) serves the
    # flat engines too.  Dogleg keeps the host loop: its radius rules
    # (dogleg.update_radius_dogleg) differ from the LM rules that loop
    # implements.
    if options.trust_region_strategy == "lm":
        fns["raw"] = {
            "bound": (),
            "prepare": lambda b, p: prepare(p),
            "solve_step": lambda b, aux, radius: solve_step(aux, radius),
            "apply_step": lambda b, p, dx: apply_step(p, dx),
            "cost_decrease": lambda b, a, c: residuals.cost_decrease(
                a, c, problem),
            "rho_slots": lambda b, p: residuals.rho_obs(p, problem),
            "cost_decrease_pair": lambda b, rho_ref, c:
                residuals.cost_decrease_pair(rho_ref, c, problem),
        }
    return fns


def rebindable(problem: Problem, options: SolverOptions) -> bool:
    """Whether the engine that ``options`` pick for ``problem`` builds
    nothing at make time from the problem's data, only from its shapes and
    index tensors, and runs on the device loop: then a later problem of
    the same structure may reuse it with its own data copied in
    (``lm_device.engines``).  These are the flat LM engines (``dense``,
    ``dense_schur``, ``iterative_schur``, whose groupings and clusters
    read the index tensors alone) under ``device_loop`` "auto" or "on".
    ``auto`` picks ``iterative_schur`` from the shapes alone where they
    rule the window layout out; elsewhere the window plan decides, and it
    packs ``uv``, ``t`` and ``mask``.  The banded engine and the dogleg
    never qualify."""
    if options.trust_region_strategy != "lm" or options.device_loop == "off":
        return False
    if options.linear_solver == "auto":
        from .window import shapes_admit
        return not shapes_admit(problem)
    return options.linear_solver in ("dense", "dense_schur",
                                     "iterative_schur")


def _finite(tree) -> bool:
    leaves = tree.values() if isinstance(tree, dict) else [tree]
    return all(bool(torch.isfinite(v).all()) for v in leaves)


def solve(problem: Problem, params: Params,
          options: SolverOptions = SolverOptions(),
          callback: Optional[Callable] = None,
          fns: Optional[dict] = None,
          summary: Optional[Summary] = None) -> Tuple[Params, Summary]:
    """Run LM to convergence.  Returns (optimized params, Summary).

    ``callback(iteration, params, iteration_summary)`` runs after every
    accepted step.  ``fns`` overrides the phase functions (see
    ``make_solver_fns``).  Without it an engine that qualifies
    (``rebindable``) comes from the process's cache
    (``lm_device.engines``), which reuses an engine and its captured
    graphs for every problem of the same structure; the ``solve`` span's
    ``engine_cache`` says "hit", "miss" or "bypass" (not cached).
    ``summary`` continues an existing Summary, so that a record stream
    can span restarts.

    With ``device_loop`` "auto" or "on" and an engine that exposes raw
    phase closures, the on-device loop runs the solve: captured in CUDA
    graphs on a CUDA problem, eagerly on a CPU problem, and the evaluator
    tag gets "+device_loop".  Its phase times are device times: while a
    profiler records (``utils/trace.py``) when the graphs are captured
    and replayed, ``evaluation_time`` is the prepares' and residual
    passes' device seconds and ``linear_solver_time`` the step solves';
    otherwise, and eagerly on the CPU, both stay 0.  The host loop times
    its phases on the host clock (each ends in a read-back).

    With ``matmul_precision="highest"`` TF32 is turned off for CUDA
    matmuls and cuDNN (a process-wide PyTorch setting), before anything
    is captured.
    """
    with trace.span("solve") as sp:
        params, summary = _solve(problem, params, options, callback, fns,
                                 summary, sp)
    summary.total_time = sp.seconds
    return params, summary


def _solve(problem, params, options, callback, fns, summary, sp):
    """``solve`` inside its span ``sp``."""
    if options.matmul_precision == "highest":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if options.check_gradients:
        from .gradient_check import check_gradients
        tol = options.gradient_check_relative_precision or (
            1e-5 if params.dtype == torch.float64 else 2e-3)
        check_gradients(problem, params, relative_precision=tol)
    cached = "bypass"
    if fns is None and rebindable(problem, options):
        from . import lm_device
        fns, cached = lm_device.engines.fns(
            problem, params, options,
            lm_device.block_size(options, callback is not None),
            make_solver_fns)
    elif fns is None:
        fns = make_solver_fns(problem, options)
    sp.set(engine_cache=cached)
    engine = fns.get("engine", (options.linear_solver, ""))
    if summary is None:
        summary = Summary()
    summary.linear_solver, summary.evaluator = engine
    summary.num_residuals = int(2 * torch.sum(problem.obs.mask))
    summary.num_parameters_tangent = assembly.tangent_shapes(
        problem, params).total_dim

    # The window solver keeps points in a padded internal layout; convert
    # at the solve boundary (and for user-visible callbacks).
    to_external = fns.get("to_external")
    if to_external is not None:
        params = fns["to_internal"](params)
    sq0, n_valid, sq0_in, n_in = fns["error_stats"](params)
    summary.initial_rmse = _rmse(sq0, n_valid)
    summary.initial_rmse_inlier = _rmse(sq0_in, n_in)
    summary.preprocessing_time = sp.elapsed()

    if options.device_loop == "on" and "raw" not in fns:
        raise ValueError(
            "device_loop='on' requires an engine exposing raw phase "
            f"functions; this engine ({engine[0]}/{engine[1]}) does not")
    if options.device_loop != "off" and "raw" in fns:
        from . import lm_device
        summary.evaluator = engine[1] + "+device_loop"
        params = lm_device.run_blocks(fns, params, options, summary,
                                      callback, to_external)
        return _finish(fns, params, summary, to_external)

    radius = options.initial_radius
    decrease_factor = 2.0
    invalid_steps = 0
    terminated = False
    dogleg_rule = options.trust_region_strategy == "dogleg"
    # Below float64 a rejected full Gauss-Newton step halves the radius
    # from its own norm, and the dogleg ends at the optimum (gn_flat
    # below); in float64 its rules are the reference's.
    dogleg_f32 = dogleg_rule and problem.obs.uv.dtype != torch.float64
    if dogleg_rule:
        from .dogleg import cost_resolution, update_radius_dogleg
    if dogleg_f32:
        resolution = cost_resolution(problem)

    for _ in range(options.max_iterations):
        it_t0 = time.perf_counter()
        with trace.span("lm.prepare") as phase:
            aux = fns["prepare"](params)
            cost = float(aux["cost"])                    # synchronises
            gmax = float(aux["gradient_max_norm"])
        summary.evaluation_time += phase.seconds
        if summary.num_iterations == 0:
            summary.initial_cost = cost
        if not math.isfinite(cost):
            summary.termination = "FAILURE"
            summary.message = "non-finite cost"
            terminated = True
            break
        if gmax <= options.gradient_tolerance:
            summary.termination = "CONVERGENCE"
            summary.message = (f"gradient tolerance reached: "
                               f"{gmax:.3e} <= {options.gradient_tolerance}")
            terminated = True
            break

        accepted = False
        rho = 0.0
        step_norm = 0.0
        new_cost = cost
        if dogleg_f32:
            gn_norm = float(aux["gn_norm"])
            flat_tol = max(options.function_tolerance * cost,
                           resolution * math.sqrt(max(cost, 0.0)))
        else:
            gn_norm = math.inf
        while not accepted and radius >= options.min_radius:
            with trace.span("lm.solve_step") as phase:
                dx, predicted, lin_iters = fns["solve_step"](aux, radius)
                pred = float(predicted)
                dx_finite = _finite(dx)
            summary.linear_solver_time += phase.seconds
            cand, snorm, x_norm = fns["apply_step"](params, dx)
            step_norm = float(snorm)
            # Dogleg below float64: the attempt is the full Gauss-Newton
            # point, the model's exact minimiser.  If it predicts no more
            # than function tolerance, or than the dtype resolves of a
            # cost change, in either sign, the model has nothing left to
            # give that could be verified: rejected, it ends the solve.
            gn_step = gn_norm <= radius
            gn_flat = (gn_step and dx_finite and math.isfinite(pred)
                       and abs(pred) <= flat_tol)
            if not (gn_flat or (dx_finite and pred > 0
                                and math.isfinite(pred))):
                # Invalid step: shrink and retry (Ceres counts these).
                invalid_steps += 1
                radius /= decrease_factor
                decrease_factor *= 2.0
                if invalid_steps > options.max_invalid_steps:
                    summary.termination = "FAILURE"
                    summary.message = "too many consecutive invalid steps"
                    terminated = True
                break
            invalid_steps = 0
            # Pairwise-differenced decrease (f32-safe).
            with trace.span("lm.cost_decrease"):
                decrease = float(fns["cost_decrease"](params, cand))
            new_cost = cost - decrease
            rho = decrease / pred if pred > 0 else 0.0
            if (pred > 0 and math.isfinite(new_cost)
                    and rho > options.min_relative_decrease):
                accepted = True
                if dogleg_rule:
                    radius = update_radius_dogleg(radius, rho, step_norm,
                                                  True, options)
                else:
                    # Ceres radius growth: μ ← μ / max(1/3, 1 − (2ρ−1)³)
                    radius = min(radius / max(1.0 / 3.0,
                                              1.0 - (2.0 * rho - 1.0) ** 3),
                                 options.max_radius)
                decrease_factor = 2.0
            else:
                if dogleg_rule:
                    radius = update_radius_dogleg(radius, rho, step_norm,
                                                  False, options, gn_step)
                else:
                    radius /= decrease_factor
                    decrease_factor *= 2.0
                if gn_flat:
                    summary.termination = "CONVERGENCE"
                    summary.message = (
                        f"function tolerance reached: the Gauss-Newton "
                        f"step predicts {pred:.3e} <= {flat_tol:.3e}, "
                        f"|Δcost| {abs(cost - new_cost):.3e}, on cost "
                        f"{cost:.6e}")
                    terminated = True
                # Stagnation: predicted and actual change both below
                # function tolerance — the optimum is resolved to working
                # precision.
                elif (pred <= options.function_tolerance * cost
                        and abs(cost - new_cost)
                        <= options.function_tolerance * cost):
                    summary.termination = "CONVERGENCE"
                    summary.message = ("function tolerance reached "
                                       "(stagnant rejected step)")
                    terminated = True

            it = IterationSummary(
                iteration=summary.num_iterations,
                cost=new_cost if accepted else cost,
                cost_change=cost - new_cost, gradient_max_norm=gmax,
                step_norm=step_norm, relative_decrease=float(rho),
                trust_region_radius=radius, accepted=accepted,
                linear_solver_iterations=int(lin_iters),
                wall_time=time.perf_counter() - it_t0)
            summary.iterations.append(it)
            if accepted:
                summary.num_successful_steps += 1
            else:
                summary.num_unsuccessful_steps += 1
            if options.verbose:
                print(f"  iter {it.iteration:3d} cost {it.cost:.6e} "
                      f"|g| {gmax:.3e} step {step_norm:.3e} "
                      f"rho {rho:+.3f} radius {radius:.2e} "
                      f"{'ACCEPT' if accepted else 'reject'}")

            if accepted:
                params = cand
                if callback is not None:
                    callback(summary.num_iterations,
                             to_external(params) if to_external is not None
                             else params, it)
                # Convergence tests (Ceres ordering: after accepted step).
                cost_change = cost - new_cost
                if abs(cost_change) <= options.function_tolerance * cost:
                    summary.termination = "CONVERGENCE"
                    summary.message = (
                        f"function tolerance reached: |Δcost|/cost = "
                        f"{abs(cost_change) / max(cost, 1e-30):.3e}")
                    terminated = True
                elif step_norm <= options.parameter_tolerance * (
                        float(x_norm) + options.parameter_tolerance):
                    summary.termination = "CONVERGENCE"
                    summary.message = "parameter tolerance reached"
                    terminated = True
            if terminated:
                break

        if radius < options.min_radius and not accepted:
            summary.termination = "CONVERGENCE"
            summary.message = "trust region radius below minimum"
            terminated = True
        if terminated:
            break

    if not terminated:
        summary.termination = "NO_CONVERGENCE"
        summary.message = f"max iterations ({options.max_iterations}) reached"

    return _finish(fns, params, summary, to_external)


def _finish(fns, params, summary, to_external):
    """Final cost and error statistics; parameters back in the caller's
    layout."""
    with trace.span("solve.finish"):
        summary.final_cost = float(fns["cost"](params))
        sqf, n_valid, sqf_in, n_in = fns["error_stats"](params)
        summary.final_rmse = _rmse(sqf, n_valid)
        summary.final_rmse_inlier = _rmse(sqf_in, n_in)
        if to_external is not None:
            params = to_external(params)
    return params, summary
