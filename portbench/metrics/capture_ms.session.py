"""capture_ms.session (ms): the program's graph-capture seconds
(lm_device._Runner.capture_seconds) per frame."""
from portbench import stats


def read(run):
    return stats.per_item(1e3 * sum(f["capture_s"] for f in run.frames),
                          len(run.frames))
