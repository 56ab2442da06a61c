"""ba_ms_per_frame (ms): add_frame's report wall_s["ba"], summed over the
window's frames, per frame."""
from portbench import stats


def read(run):
    return stats.per_item(
        1e3 * sum(f.get("stages", {}).get("ba", 0.0) for f in run.frames),
        len(run.frames))
