"""plan_ms.solve (ms): host wall of make_solver_fns (the window plan and
the engine) per solve, in a traced run, where requests are split."""
from portbench import stats


def read(run):
    v = [s["plan_s"] for s in run.solves if "plan_s" in s]
    return stats.per_item(1e3 * sum(v), len(v))
