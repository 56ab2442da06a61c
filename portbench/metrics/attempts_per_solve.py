"""attempts_per_solve (count): Summary.num_iterations per completed solve."""
from portbench import stats


def read(run):
    v = [s["attempts"] for s in run.solves if "attempts" in s]
    return stats.per_item(sum(v), len(v))
