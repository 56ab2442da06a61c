"""factor_solve_ms_per_attempt (ms): device time of the dense Schur
engine's factorisation and solves (the program's device span
``factor_solve``: the Cholesky of S, both solves through it and the
refinement sweep, inside the captured attempt) over the profiled solves,
per device ``attempt`` span."""
from portbench import spans


def read(run):
    return spans.device_ms_per_attempt("factor_solve")
