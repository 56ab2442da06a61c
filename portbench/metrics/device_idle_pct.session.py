"""device_idle_pct.session (%): 100 (1 - busy / span) over the profiled
frames: busy is the union of the device operations' intervals."""
from portbench import stats


def read(run):
    if run.trace is None:
        return None
    return stats.idle_pct(run.trace["busy_s"], run.trace["window_s"])
