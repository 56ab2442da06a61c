"""solve_s (s): the whole window's wall over the solves it completed."""


def read(run):
    return run.window_s / len(run.solves) if run.solves else None
