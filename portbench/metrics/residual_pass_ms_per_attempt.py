"""residual_pass_ms_per_attempt (ms): device time of the retraction and
the cost decrease's residual pass (the program's device span
``residual_pass``, inside the captured attempt) over the profiled
solves, per device ``attempt`` span."""
from portbench import spans


def read(run):
    return spans.device_ms_per_attempt("residual_pass")
