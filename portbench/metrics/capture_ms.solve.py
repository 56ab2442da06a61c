"""capture_ms.solve (ms): the program's graph-capture seconds
(lm_device._Runner.capture_seconds) per solve."""
from portbench import stats


def read(run):
    return stats.per_item(1e3 * sum(s["capture_s"] for s in run.solves),
                          len(run.solves))
