"""Levenberg–Marquardt trust-region driver (host loop).

Counterpart of ``rsba_tpu/solver/lm.py``: Ceres ``TrustRegionMinimizer``
+ ``LevenbergMarquardtStrategy`` semantics — damping λ = 1/μ, step
acceptance by relative decrease ρ, Ceres's radius update rules and the
same convergence tests (gradient / function / parameter tolerance).

The loop runs on the host and calls the phase functions in turn
(prepare, solve_step, apply_step, cost_decrease), reading back only
scalars.  The on-device loop is not ported yet (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import math
import time
from typing import Callable, Optional, Tuple

import torch

from ..problem.types import POSE_DOF, Params, Problem
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

    ``linear_solver`` "auto" and "banded_schur" build the window plan and
    the fused banded engine (``banded_fused``); ``fns["engine"]`` records
    the resolved (linear_solver, evaluator) pair.  The flat engines and
    dogleg are not ported yet and raise NotImplementedError.
    """
    if options.trust_region_strategy == "dogleg":
        raise NotImplementedError(
            "trust_region_strategy='dogleg' is not ported yet "
            "(ROADMAP.md, Queue 1: other solver features)")
    if options.linear_solver not in ("auto", "banded_schur"):
        raise NotImplementedError(
            f"linear_solver={options.linear_solver!r} is not ported yet "
            "(ROADMAP.md, Queue 1: flat engines)")
    from .window import build_window_plan
    plan = build_window_plan(problem)
    if plan is None:
        if options.linear_solver == "banded_schur":
            raise ValueError(
                "banded_schur requires window/track structure (bounded "
                "pose spans, pose_b ∈ {pose_a, pose_a+1}, single fixed "
                "intrinsics block)")
        raise NotImplementedError(
            "the problem does not fit the window layout, and the flat "
            "iterative_schur fallback is not ported yet (ROADMAP.md, "
            "Queue 1: flat engines)")
    from .banded_fused import make_fused_solver_fns
    return make_fused_solver_fns(problem, plan, options)


def solve(problem: Problem, params: Params,
          options: SolverOptions = SolverOptions(),
          callback: Optional[Callable] = None,
          fns: Optional[dict] = None) -> Tuple[Params, Summary]:
    """Run LM to convergence.  Returns (optimized params, Summary).

    ``callback(iteration, params, iteration_summary)`` runs after every
    accepted step.  ``fns`` overrides the phase functions (see
    ``make_solver_fns``).
    With ``matmul_precision="highest"`` TF32 is turned off for CUDA
    matmuls and cuDNN (a process-wide PyTorch setting).
    """
    t_start = time.perf_counter()
    if options.device_loop == "on":
        raise NotImplementedError(
            "device_loop='on' is not ported yet (ROADMAP.md, Queue 1: "
            "on-device loop)")
    if options.matmul_precision == "highest":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if fns is None:
        fns = make_solver_fns(problem, options)
    engine = fns.get("engine", (options.linear_solver, ""))
    summary = Summary()
    summary.linear_solver, summary.evaluator = engine
    summary.num_residuals = int(2 * torch.sum(problem.obs.mask))
    summary.num_parameters_tangent = (
        POSE_DOF * params.n_poses
        + problem.intr_tangent_dim * params.intr.shape[0]
        + 3 * params.n_points)

    to_external = fns["to_external"]
    params = fns["to_internal"](params)
    sq0, n_valid, sq0_in, n_in = fns["error_stats"](params)
    summary.initial_rmse = _rmse(sq0, n_valid)
    summary.initial_rmse_inlier = _rmse(sq0_in, n_in)
    summary.preprocessing_time = time.perf_counter() - t_start

    radius = options.initial_radius
    decrease_factor = 2.0
    invalid_steps = 0
    terminated = False

    def finite(x) -> bool:
        return all(bool(torch.isfinite(v).all()) for v in x.values())

    for _ in range(options.max_iterations):
        it_t0 = time.perf_counter()
        aux = fns["prepare"](params)
        cost = float(aux["cost"])                    # synchronises
        gmax = float(aux["gradient_max_norm"])
        summary.evaluation_time += time.perf_counter() - it_t0
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
        while not accepted and radius >= options.min_radius:
            t0 = time.perf_counter()
            dx, predicted, lin_iters = fns["solve_step"](aux, radius)
            pred = float(predicted)
            dx_finite = finite(dx)
            summary.linear_solver_time += time.perf_counter() - t0
            cand, snorm, x_norm = fns["apply_step"](params, dx)
            step_norm = float(snorm)
            if not (dx_finite and pred > 0 and math.isfinite(pred)):
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
            decrease = float(fns["cost_decrease"](params, cand))
            new_cost = cost - decrease
            rho = decrease / pred
            if math.isfinite(new_cost) and rho > options.min_relative_decrease:
                accepted = True
                # Ceres radius growth: μ ← μ / max(1/3, 1 − (2ρ−1)³)
                radius = min(radius / max(1.0 / 3.0,
                                          1.0 - (2.0 * rho - 1.0) ** 3),
                             options.max_radius)
                decrease_factor = 2.0
            else:
                radius /= decrease_factor
                decrease_factor *= 2.0
                # Stagnation: predicted and actual change both below
                # function tolerance — the optimum is resolved to working
                # precision.
                if (pred <= options.function_tolerance * cost
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
                    callback(summary.num_iterations, to_external(params), it)
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

    summary.final_cost = float(fns["cost"](params))
    sqf, n_valid, sqf_in, n_in = fns["error_stats"](params)
    summary.final_rmse = _rmse(sqf, n_valid)
    summary.final_rmse_inlier = _rmse(sqf_in, n_in)
    params = to_external(params)
    summary.total_time = time.perf_counter() - t_start
    return params, summary
