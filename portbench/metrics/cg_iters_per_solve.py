"""cg_iters_per_solve (count): the sum of linear_solver_iterations over
a solve's attempts, per completed solve."""
from portbench import stats


def read(run):
    v = [s["cg_iters"] for s in run.solves if "cg_iters" in s]
    return stats.per_item(sum(v), len(v))
