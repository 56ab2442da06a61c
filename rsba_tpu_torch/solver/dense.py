"""Dense linear solver: full normal equations + Cholesky.

Counterpart of ``rsba_tpu/solver/dense.py`` (Ceres
``DENSE_NORMAL_CHOLESKY``): for small problems, and as the exact oracle
the Schur path is checked against.  Includes Ceres-style Jacobi column
scaling and optional iterative refinement.
"""
from __future__ import annotations

import torch

from ..problem.types import Params, Problem
from . import assembly, residuals
from .options import SolverOptions


def cholesky_solve(A: torch.Tensor, b: torch.Tensor,
                   refinement_steps: int = 0) -> torch.Tensor:
    """Solve A x = b via Cholesky with optional iterative refinement.  A
    matrix that is not positive definite gives a non-finite x (no error
    check reads back to the host)."""
    L, _ = torch.linalg.cholesky_ex(A, check_errors=False)

    def chol_apply(rhs):
        return torch.cholesky_solve(rhs[:, None], L)[:, 0]

    x = chol_apply(b)
    for _ in range(refinement_steps):
        x = x + chol_apply(b - A @ x)
    return x


def lm_damped_system(H: torch.Tensor, g: torch.Tensor, radius,
                     options: SolverOptions):
    """Build the scaled, damped system; returns (A, rhs, unscale vector).

    Jacobi scaling s = 1/(1+√diag(H)) (Ceres's column scaling), dead
    dimensions (constant blocks → zero diag) pinned with identity, LM
    diagonal clamped to [min_lm_diagonal, max_lm_diagonal] and divided by
    the trust-region radius.
    """
    diag = torch.diagonal(H)
    dead = diag <= 0.0
    s = torch.where(dead, 1.0,
                    1.0 / (1.0 + torch.sqrt(torch.clamp(diag, min=0.0))))
    Hs = H * s[:, None] * s[None, :]
    lm_diag = torch.clamp(torch.diagonal(Hs), options.min_lm_diagonal,
                          options.max_lm_diagonal) / radius
    A = Hs + torch.diag(lm_diag + dead.to(H.dtype))
    return A, -(g * s), s


#: materialize the explicit (2N, D) Jacobian only below this element count;
#: larger problems get the same exact step via point-block elimination.
_DENSE_MATERIALIZE_MAX_ELEMS = 1 << 26


def materializes_dense(problem: Problem) -> bool:
    """Whether ``make_dense_solver`` builds the explicit Jacobian."""
    shapes = assembly.static_shapes(problem)
    return (2 * int(problem.obs.uv.shape[0]) * shapes.total_dim
            <= _DENSE_MATERIALIZE_MAX_ELEMS)


def make_dense_solver(problem: Problem, options: SolverOptions,
                      materialize: bool | None = None):
    """(prepare, solve_step) closures for the LM loop.

    ``materialize=None`` (auto): the explicit dense Jacobian/H path runs
    only while (2N, D) stays small.  Above the threshold the same damped
    normal equations are solved exactly by point-block elimination
    (``schur.py``): elimination is a factorization order, not a different
    solver, so the step is the solution of the identical system (same
    Jacobi scaling, same clamped LM diagonal, same refinement against the
    matrix-free operator) without the (2N, D) temporary.
    """
    if materialize is None:
        materialize = materializes_dense(problem)
    if not materialize:
        from .schur import make_dense_schur_solver
        return make_dense_schur_solver(problem, options)

    shapes = assembly.static_shapes(problem)

    def prepare(params: Params):
        ev = residuals.evaluate(params, problem)
        H, g = assembly.dense_normal_equations(ev, problem, shapes)
        return {"cost": ev.cost, "H": H, "g": g,
                "gradient_max_norm": g.abs().max()}

    def solve_step(aux, radius):
        H, g = aux["H"], aux["g"]
        A, rhs, s = lm_damped_system(H, g, radius, options)
        y = cholesky_solve(A, rhs, options.refinement_steps)
        # Predicted decrease via the cancellation-free LM identity
        # ½(δᵀλD²δ − gᵀδ), in scaled space, where the damped system is
        # (Hs + diag(lm))y = −gs.
        lm_diag = torch.diagonal(A) - torch.diagonal(H) * s * s
        predicted = 0.5 * (torch.sum(lm_diag * y * y) - torch.dot(g * s, y))
        return s * y, predicted, torch.zeros((), dtype=torch.int32,
                                             device=y.device)

    return prepare, solve_step
