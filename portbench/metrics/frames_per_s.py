"""frames_per_s (frames/s): frames ingested over the whole window."""
from portbench import stats


def read(run):
    return stats.rate(len(run.frames), run.window_s) if run.frames else None
