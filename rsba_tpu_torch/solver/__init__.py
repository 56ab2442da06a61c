from .lm import make_solver_fns, solve
from .options import SolverOptions
from .summary import IterationSummary, Summary

__all__ = ["make_solver_fns", "solve", "SolverOptions", "IterationSummary",
           "Summary"]
