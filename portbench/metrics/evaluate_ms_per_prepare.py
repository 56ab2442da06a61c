"""evaluate_ms_per_prepare (ms): device time of the dense Schur engine's
evaluation (the program's device span ``evaluate``: the Jacobians,
diag(JᵀJ) and the Jacobi scaling, inside the captured re-prepare) over
the profiled solves, per device ``prepare`` span."""
from portbench import spans, stats


def read(run):
    recs = spans.records()
    part = spans.named(recs, "evaluate", device=True)
    if not part:
        return None
    return stats.per_item(1e3 * spans.seconds(part),
                          len(spans.named(recs, "prepare", device=True)))
