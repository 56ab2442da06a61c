"""assemble_ms_per_prepare (ms): device time of the dense Schur engine's
assembly (the program's device span ``assemble``: the gradient, B, Eᵀ
and the point blocks C, inside the captured re-prepare) over the
profiled solves, per device ``prepare`` span."""
from portbench import spans, stats


def read(run):
    recs = spans.records()
    part = spans.named(recs, "assemble", device=True)
    if not part:
        return None
    return stats.per_item(1e3 * spans.seconds(part),
                          len(spans.named(recs, "prepare", device=True)))
