"""band_pcg_ms_per_attempt (ms): device time of the band PCG kernel's
launch (the program's device span ``band_pcg``, inside ``pcg``) over the
profiled solves, per device ``attempt`` span."""
from portbench import spans


def read(run):
    return spans.device_ms_per_attempt("band_pcg")
