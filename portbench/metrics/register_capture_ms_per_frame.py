"""register_capture_ms_per_frame (ms): host time of the graph captures
made inside registration (the program's ``loop.capture`` spans under a
``register`` span) over the profiled frames, per ``frame`` span."""
from portbench import spans


def read(run):
    caps = spans.within(spans.named(spans.records(), "loop.capture"),
                        "register")
    return spans.per_frame(1e3 * spans.seconds(caps))
