"""pcg_ms_per_attempt (ms): device time of the banded solve's PCG (the
program's device span ``pcg``, inside the captured attempt) over the
profiled solves, per device ``attempt`` span."""
from portbench import spans


def read(run):
    return spans.device_ms_per_attempt("pcg")
