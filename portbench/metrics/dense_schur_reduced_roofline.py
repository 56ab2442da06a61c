"""dense_schur_reduced_roofline (%): the least time the dense Schur
engine's reduced camera system needs (``roofline_bal.reduced_bound``,
from each profiled problem's index arrays, averaged over its spans) over
the mean device time of the program's device spans ``reduced_system`` in
the profiled slice."""
from portbench import spans


def read(run):
    bound = run.counters.get("dense_schur_reduced_bound_s")
    recs = spans.named(spans.records(), "reduced_system", device=True)
    if bound is None or not recs:
        return None
    return 100.0 * bound * len(recs) / spans.seconds(recs)
