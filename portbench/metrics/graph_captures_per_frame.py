"""graph_captures_per_frame (count): the captured loop's graph captures
(the program's ``loop.capture`` spans) over the profiled frames, per
``frame`` span."""
from portbench import spans


def read(run):
    return spans.per_frame(len(spans.named(spans.records(), "loop.capture")))
