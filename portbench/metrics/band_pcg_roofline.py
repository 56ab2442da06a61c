"""band_pcg_roofline (%): the band PCG kernel's byte bound for the
profiled solves' live passes over the device time of its launches.

Solve by solve: the profiled solves are the window's first, one for each
of the program's root ``solve`` spans, in order.  Each solve's bound is
``roofline_band_pcg.bound_s`` of the band its ``band_pcg.plan`` spans
record (P, W, value size) and of its own ``cg_iters``; its time is that
of the device spans ``band_pcg`` under the same root.  Solves with no
plan span or no device span add nothing.  The bound charges every pass's
bytes at the HBM rate, whichever launch plan runs: a share of that rate,
not of a least time (``roofline_band_pcg``)."""
from collections import defaultdict

from portbench import roofline_band_pcg, spans


def read(run):
    recs = spans.records()
    roots = [r["id"] for r in spans.named(recs, "solve")
             if r["parent"] is None]
    shape = {r["request"]: (r["attrs"]["P"], r["attrs"]["W"],
                            r["attrs"]["itemsize"])
             for r in spans.named(recs, "band_pcg.plan")}
    seconds = defaultdict(float)
    for r in spans.named(recs, "band_pcg", device=True):
        seconds[r["request"]] += r["seconds"] or 0.0
    bound = busy = 0.0
    for root, rec in zip(roots, run.solves):
        if root in shape and seconds[root] > 0:
            bound += roofline_band_pcg.bound_s(*shape[root],
                                               rec.get("cg_iters", 0))
            busy += seconds[root]
    return 100.0 * bound / busy if busy > 0 else None
