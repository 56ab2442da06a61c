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

import torch

from ..problem.types import Params, Problem
from .options import SolverOptions

#: trust-region radius used to extract the near-undamped Gauss-Newton
#: step from the base LM solver: λ = clamp(diag)/1e8.  Not ∞: free-gauge
#: BA Hessians carry an exact scale null direction, and a truly undamped
#: Cholesky factorizes a singular matrix into NaNs; the 1e-8-relative
#: damping regularizes only the null space.
_GN_RADIUS = 1e8
#: the same in float32, where a 1e-8-relative damping is below the
#: resolution of the diagonal it is added to and the factorization of the
#: gauge directions returns noise (measured on gs_small at full size: 40
#: accepted steps and 12 px RMSE, against 4 steps in float64)
_GN_RADIUS_F32 = 1e5


def make_dogleg_solver(problem: Problem, options: SolverOptions):
    """(prepare, solve_step) for the LM loop, dogleg strategy.

    Wraps the exact-step base engine named by ``options.linear_solver``;
    ``solve_step(aux, radius)`` returns (dx, predicted_decrease, 0) like
    every other engine, so the trust-region loop is unchanged apart
    from its radius-update rule (see ``lm.solve``).
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

    def prepare(params: Params):
        aux = dict(prepare_b(params))
        dx_gn, _, _ = solve_b(aux, _GN_RADIUS
                              if aux["cost"].dtype == torch.float64
                              else _GN_RADIUS_F32)
        g = gradient(aux)
        aux["dx_gn"] = dx_gn
        aux["g_flat"] = g
        aux["gg"] = torch.dot(g, g)
        aux["gHg"] = torch.dot(g, h_apply(aux, g))
        return aux

    def solve_step(aux, radius):
        dx_gn = aux["dx_gn"]
        g = aux["g_flat"]
        gg, gHg = aux["gg"], aux["gHg"]
        radius = torch.as_tensor(radius, dtype=g.dtype, device=g.device)

        alpha = torch.where(gHg > 0, gg / torch.clamp(gHg, min=1e-30), 0.0)
        dx_sd = -alpha * g
        n_sd = alpha * torch.sqrt(gg)
        # A non-finite GN solve (factorization breakdown) degrades to the
        # Cauchy segment: n_gn = ∞ keeps the GN branch unselected.
        finite = torch.isfinite(dx_gn)
        gn_ok = finite.all()
        dx_gn = torch.where(finite, dx_gn, 0.0)
        n_gn = torch.where(gn_ok, torch.linalg.vector_norm(dx_gn),
                           torch.inf)
        dx_gn = torch.where(gn_ok, dx_gn, dx_sd)

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
                         accepted: bool, options: SolverOptions) -> float:
    """Ceres DoglegStrategy radius rules (StepAccepted/StepRejected).

    Accepted: poor-but-acceptable steps (ρ < 0.25) halve the radius; very
    good steps (ρ > 0.75) grow it to ≥ 3·‖step‖.  Rejected: halve.  (No
    lower clamp: the loop terminates when the radius undershoots
    ``options.min_radius``.)
    """
    if accepted:
        if rho < 0.25:
            radius = 0.5 * radius
        elif rho > 0.75:
            radius = max(radius, 3.0 * step_norm)
    else:
        radius = 0.5 * radius
    return min(radius, options.max_radius)
