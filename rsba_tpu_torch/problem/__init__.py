from . import synthetic, types
from .types import (Observations, Params, Problem, intr_basis_bal,
                    intr_basis_fixed, make_problem, params_from_numpy,
                    problem_from_numpy, to_numpy, validate_problem)

__all__ = [
    "synthetic", "types", "Observations", "Params", "Problem",
    "intr_basis_bal", "intr_basis_fixed", "make_problem",
    "params_from_numpy", "problem_from_numpy", "to_numpy",
    "validate_problem",
]
