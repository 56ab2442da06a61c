"""reduced_system_ms_per_attempt (ms): device time of the damped reduced
camera system (the program's device span ``reduced_system``, inside the
captured attempt) over the profiled solves, per device ``attempt`` span."""
from portbench import spans


def read(run):
    return spans.device_ms_per_attempt("reduced_system")
