"""flat_pcg_roofline (%): the flat ``iterative_schur`` PCG's byte bound for
the profiled solves' live passes over the device time of its ``pcg``
spans (the preconditioned CG loop and the back-substitution).

Solve by solve: the profiled solves are the window's first, one for each
of the program's root ``solve`` spans, in order.  Each solve's bound is
``roofline_flat_pcg.bound_s`` of the sizes its root span records (``N``,
``M``, ``P``, ``n_intr``, ``ni``, ``itemsize``; an ``iterative_schur``
solve's, whether its engine was built or found in the cache) and of its
own ``cg_iters``; its time is that of the device spans ``pcg`` under the
same root.  The loop runs every unrolled pass, so the passes after
convergence are time and not work.  Solves whose root lacks the sizes
(another engine, or a program that does not record them) or that have no
device span add nothing."""
from collections import defaultdict

from portbench import roofline_flat_pcg, spans

SIZES = ("N", "M", "P", "n_intr", "itemsize")


def read(run):
    recs = spans.records()
    roots = [r for r in spans.named(recs, "solve") if r["parent"] is None]
    seconds = defaultdict(float)
    for r in spans.named(recs, "pcg", device=True):
        seconds[r["request"]] += r["seconds"] or 0.0
    bound = busy = 0.0
    for root, rec in zip(roots, run.solves):
        a = root["attrs"]
        if all(k in a for k in SIZES + ("ni",)) and seconds[root["id"]] > 0:
            bound += roofline_flat_pcg.bound_s(
                *(a[k] for k in SIZES), rec.get("cg_iters", 0), ni=a["ni"])
            busy += seconds[root["id"]]
    return 100.0 * bound / busy if busy > 0 else None
