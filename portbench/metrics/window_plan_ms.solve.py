"""window_plan_ms.solve (ms): host time of the window plan (the program's
span ``plan.window``, ``build_window_plan``) over the profiled solves, per
root ``solve`` span."""
from portbench import spans, stats


def read(run):
    recs = spans.records()
    plans = spans.named(recs, "plan.window")
    if not plans:
        return None
    roots = [r for r in spans.named(recs, "solve") if r["parent"] is None]
    return stats.per_item(1e3 * spans.seconds(plans), len(roots))
