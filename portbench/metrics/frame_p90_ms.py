"""frame_p90_ms (ms): the nearest-rank 90th percentile of every frame's
add_frame wall in the window (host clock, synchronised)."""
from portbench import stats


def read(run):
    walls = [f["wall_s"] for f in run.frames]
    return 1e3 * stats.percentile(walls, 90) if walls else None
