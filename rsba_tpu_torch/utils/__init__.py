from .checkpoint import SolverCheckpointer

__all__ = ["SolverCheckpointer"]
