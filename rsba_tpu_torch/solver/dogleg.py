"""Traditional Dogleg trust-region strategy.

Counterpart of ``rsba_tpu/solver/dogleg.py`` (Ceres ``DoglegStrategy``,
TRADITIONAL_DOGLEG).  Dogleg needs an exact step solver, since the
Gauss-Newton point must be a real minimizer for the dogleg path to make
sense, so it composes with ``dense`` and ``dense_schur`` only.

The expensive work (one factorization + Gauss-Newton solve, one
Hessian-gradient product) happens once per Jacobian inside ``prepare``;
each trust-region retry is a closed-form blend of the cached Cauchy and
Gauss-Newton points.

Space convention: the dogleg geometry runs in the unscaled tangent
space.  (Ceres blends in the Jacobi-scaled space; the scaling still
conditions the inner linear solves here, but the trust region itself is
isotropic in the raw tangent coordinates: same fixed points.)

The piecewise path for trust radius Δ:
  ‖dx_gn‖ ≤ Δ                → dx_gn                      (full GN step)
  ‖dx_sd‖ ≥ Δ                → Δ·dx_sd/‖dx_sd‖            (scaled Cauchy)
  else                        → dx_sd + β(dx_gn − dx_sd),  ‖dx‖ = Δ
with dx_sd = −(‖g‖²/‖Jg‖²)·g the Cauchy point.
"""
from __future__ import annotations

import math

import torch

from ..problem.types import Params, Problem
from .options import SolverOptions

#: Gauss-Newton damping μ, relative to the clamped diagonal.  The base
#: engines damp by clamp(diag)/radius, so the Gauss-Newton point is their
#: step at radius 1/μ.  Not μ = 0: free-gauge BA Hessians carry an exact
#: scale null direction, and a truly undamped Cholesky factorizes a
#: singular matrix into NaNs; μ regularizes only the null space.  Ceres's
#: DoglegStrategy starts at min_mu = 1e-8, multiplies μ by 10 and solves
#: again when the Gauss-Newton solve fails, and divides it by 5 after an
#: accepted step.  A μ below the dtype's resolution is not added to the
#: diagonal at all, so μ starts at max(1e-8, eps): the reference's radius
#: 1e8 in float64, 2^23 in float32.
_MIN_MU = 1e-8
_MU_INCREASE = 10.0
#: solves after the first one per Jacobian, so μ ≤ 1e5·μ_min
_MAX_GN_RETRIES = 5


def gn_start_radius(dtype: torch.dtype) -> float:
    """The base engine's radius for the least Gauss-Newton damping of a
    dtype: 1/max(1e-8, eps)."""
    return 1.0 / max(_MIN_MU, float(torch.finfo(dtype).eps))


def cost_resolution(problem: Problem) -> float:
    """2·eps·rms|uv|: times √cost, the least cost change that the
    problem's dtype resolves.  Each projection carries a round-off of
    about eps·|uv| pixels, so a cost ½‖r‖² carries eps·rms|uv|·‖r‖ with
    ‖r‖ = √(2·cost), and a change computed from two evaluations √2 times
    that.  In float32 at config 1's optimum it is 2e-6 to 7e-6 of the
    cost, above the default function tolerance of 1e-6."""
    obs = problem.obs
    ms = torch.sum(obs.mask[:, None] * obs.uv ** 2) / torch.clamp(
        torch.sum(obs.mask), min=1.0)
    eps = float(torch.finfo(obs.uv.dtype).eps)
    return 2.0 * eps * math.sqrt(float(ms))


def make_dogleg_solver(problem: Problem, options: SolverOptions):
    """(prepare, solve_step) for the LM loop, dogleg strategy.

    Wraps the exact-step base engine named by ``options.linear_solver``;
    ``solve_step(aux, radius)`` returns (dx, predicted_decrease, 0) like
    every other engine.  ``aux["gn_norm"]`` is ‖dx_gn‖ (∞ when no
    Gauss-Newton point was found): the step at a radius of at least that
    is the full Gauss-Newton point, which ``lm.solve`` reads, below
    float64, for its radius rule and its end at the optimum.
    ``aux["gn_radius"]`` is the base engine's radius 1/μ that the point
    was solved at, ``aux["gn_solves"]`` the solves that took.

    ``prepare`` solves for the Gauss-Newton point at the damping μ carried
    from the last Jacobian, divided by 5, never below max(1e-8, eps).  A
    point that is not finite, along which the model is not convex, or
    whose model value lies above the Cauchy point's is solved again at
    10·μ, at most ``_MAX_GN_RETRIES`` times; if none passes, the step
    follows the Cauchy segment.  None of the three can happen to the
    exact minimiser of a positive semi-definite model: they are a
    float32 factorization returning noise on the gauge directions.  μ
    lives in this solver's closure, as in Ceres's strategy object.
    """
    base = options.linear_solver
    if base not in ("dense", "dense_schur"):
        raise ValueError(
            "trust_region_strategy='dogleg' requires an exact step solver "
            f"(linear_solver 'dense' or 'dense_schur'), got {base!r}: "
            "the same restriction Ceres's DoglegStrategy imposes")
    from .dense import make_dense_solver, materializes_dense
    from .schur import make_dense_schur_solver
    if base == "dense":
        prepare_b, solve_b = make_dense_solver(problem, options)
    else:
        prepare_b, solve_b = make_dense_schur_solver(problem, options)

    if base == "dense" and materializes_dense(problem):

        def gradient(aux):
            return aux["g"]

        def h_apply(aux, dx):
            return aux["H"] @ dx

    else:
        # Point-block elimination (make_dense_solver hands large problems
        # to it too): aux carries the scaled gradient g̃ = D·g and the
        # scaled Jacobians.

        def gradient(aux):
            return torch.cat([aux["g_cam"] / aux["s_cam"],
                              (aux["g_pt"].reshape(-1) / aux["s_pt"])])

        def h_apply(aux, dx):
            # H = D⁻¹ H̃ D⁻¹ with H̃ the scaled GN Hessian in aux["ev"].
            s_cam = aux["s_cam"]
            s_pt = aux["s_pt"].reshape(-1, 3)
            Dc = s_cam.shape[0]
            hc, hp = prepare_b.hessian_apply(
                aux["ev"], dx[:Dc] / s_cam, dx[Dc:].reshape(-1, 3) / s_pt)
            return torch.cat([hc / s_cam, (hp / s_pt).reshape(-1)])

    state = {"radius": None}      # the last Jacobian's Gauss-Newton radius

    def exact_enough(aux, g, dx, m_sd) -> bool:
        """Whether dx can be the model's minimiser: finite, the model
        convex along it (dxᵀH dx > 0) and its value m(dx) = gᵀdx +
        ½ dxᵀH dx at most the Cauchy point's."""
        curv = torch.dot(dx, h_apply(aux, dx))
        return bool(torch.isfinite(dx).all() & (curv > 0)
                    & (torch.dot(g, dx) + 0.5 * curv <= m_sd))

    def prepare(params: Params):
        aux = dict(prepare_b(params))
        g = gradient(aux)
        gg = torch.dot(g, g)
        gHg = torch.dot(g, h_apply(aux, g))
        # the Cauchy point's model value, −½‖g‖⁴/gᵀHg
        m_sd = -0.5 * gg * gg / torch.clamp(gHg, min=1e-30)
        top = gn_start_radius(g.dtype)
        radius = (top if state["radius"] is None
                  else min(top, state["radius"] * _MU_INCREASE / 2.0))
        for retry in range(_MAX_GN_RETRIES + 1):
            if retry:
                radius /= _MU_INCREASE
            dx_gn, _, _ = solve_b(aux, radius)
            gn_ok = exact_enough(aux, g, dx_gn, m_sd)
            if gn_ok:
                break
        state["radius"] = radius
        aux["dx_gn"] = dx_gn
        aux["gn_radius"] = radius
        aux["gn_solves"] = retry + 1
        aux["gn_norm"] = (torch.linalg.vector_norm(dx_gn) if gn_ok
                          else torch.full_like(gg, torch.inf))
        aux["g_flat"] = g
        aux["gg"] = gg
        aux["gHg"] = gHg
        return aux

    def solve_step(aux, radius):
        dx_gn = aux["dx_gn"]
        g = aux["g_flat"]
        gg, gHg = aux["gg"], aux["gHg"]
        radius = torch.as_tensor(radius, dtype=g.dtype, device=g.device)

        alpha = torch.where(gHg > 0, gg / torch.clamp(gHg, min=1e-30), 0.0)
        dx_sd = -alpha * g
        n_sd = alpha * torch.sqrt(gg)
        # No Gauss-Newton point (n_gn = ∞): the Cauchy segment.
        n_gn = aux["gn_norm"]
        dx_gn = torch.where(torch.isfinite(n_gn), dx_gn, dx_sd)

        # Blend coefficient β solving ‖dx_sd + β(dx_gn − dx_sd)‖ = Δ.
        v = dx_gn - dx_sd
        vv = torch.dot(v, v)
        sv = torch.dot(dx_sd, v)
        disc = torch.clamp(sv * sv + vv * (radius ** 2 - n_sd ** 2), min=0.0)
        beta = torch.where(
            vv > 0, (-sv + torch.sqrt(disc)) / torch.clamp(vv, min=1e-30),
            0.0)
        blend = dx_sd + torch.clamp(beta, 0.0, 1.0) * v
        cauchy = dx_sd * (radius / torch.clamp(n_sd, min=1e-30))
        dx = torch.where(n_gn <= radius, dx_gn,
                         torch.where(n_sd >= radius, cauchy, blend))

        predicted = -(torch.dot(g, dx) + 0.5 * torch.dot(dx,
                                                         h_apply(aux, dx)))
        return dx, predicted, torch.zeros((), dtype=torch.int32,
                                          device=dx.device)

    return prepare, solve_step


def update_radius_dogleg(radius: float, rho: float, step_norm: float,
                         accepted: bool, options: SolverOptions,
                         gn_step: bool = False) -> float:
    """Ceres DoglegStrategy radius rules (StepAccepted/StepRejected).

    Accepted: poor-but-acceptable steps (ρ < 0.25) halve the radius; very
    good steps (ρ > 0.75) grow it to ≥ 3·‖step‖.  Rejected: halve, and
    when the step was the full Gauss-Newton point (``gn_step``, ‖step‖
    inside the radius) halve from ‖step‖: Δ ← ½·min(Δ, ‖step‖), so that
    the next attempt is not the same point again.  ``lm.solve`` passes
    ``gn_step`` below float64 only: in float64 the rules are the
    reference's.  (No lower clamp: the loop terminates when the radius
    undershoots ``options.min_radius``.)
    """
    if accepted:
        if rho < 0.25:
            radius = 0.5 * radius
        elif rho > 0.75:
            radius = max(radius, 3.0 * step_norm)
    elif gn_step:
        radius = 0.5 * min(radius, step_norm)
    else:
        radius = 0.5 * radius
    return min(radius, options.max_radius)
