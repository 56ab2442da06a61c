"""fused_evaluate_assemble_roofline (%): the fused kernel's bound for one launch
(roofline.kernel_bound from the cell's shapes) over its mean device time
by name in the profiled slice."""


def read(run):
    if run.trace is None or "fused_bound_s" not in run.counters:
        return None
    n = t = 0
    for name, (count, seconds) in run.trace["ops"].items():
        if "fused_kernel" in name:
            n, t = n + count, t + seconds
    return 100.0 * run.counters["fused_bound_s"] * n / t if t > 0 else None
