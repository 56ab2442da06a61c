from . import assembly, residuals
from .lm import make_solver_fns, solve
from .options import SolverOptions
from .summary import IterationSummary, Summary

__all__ = ["assembly", "residuals", "make_solver_fns", "solve",
           "SolverOptions", "IterationSummary", "Summary"]
