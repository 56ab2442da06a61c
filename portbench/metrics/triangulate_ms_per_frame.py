"""triangulate_ms_per_frame (ms): host time of the session's
triangulation (the program's ``triangulate`` spans) over the profiled
frames, per ``frame`` span."""
from portbench import spans


def read(run):
    return spans.per_frame(
        1e3 * spans.seconds(spans.named(spans.records(), "triangulate")))
