"""The program's own spans (``rsba_tpu_torch/utils/trace.py``) over the
profiled slice of a traced run, for the metric readers.

The program keeps a record of each span while a profiler records, which
in a run is the traced slice alone (set-up and warm-up run with no
profiler).  A program without that module gives no records, and the
readers of these spans then report nothing.
"""
from __future__ import annotations

from . import stats


def records() -> list:
    """The program's span records, or none where it keeps none."""
    try:
        from rsba_tpu_torch.utils import trace
    except ImportError:
        return []
    return trace.records()


def named(recs: list, name: str, device: bool = False) -> list:
    """The host (or device) records of ``name``."""
    return [r for r in recs if r["name"] == name and r["device"] == device]


def seconds(recs: list) -> float:
    return sum(r["seconds"] or 0.0 for r in recs)


def within(recs: list, outer: str) -> list:
    """The records in ``recs`` that have an ancestor named ``outer``,
    looked up among all the program's records."""
    by_id = {r["id"]: r for r in records()}

    def inside(r) -> bool:
        p = by_id.get(r["parent"])
        while p is not None:
            if p["name"] == outer:
                return True
            p = by_id.get(p["parent"])
        return False
    return [r for r in recs if inside(r)]


def device_ms_per_attempt(name: str):
    """Device milliseconds of the spans ``name`` per device ``attempt``
    span, or None where there are none of ``name``."""
    recs = records()
    part = named(recs, name, device=True)
    if not part:
        return None
    return stats.per_item(1e3 * seconds(part),
                          len(named(recs, "attempt", device=True)))


def per_frame(total: float):
    """``total`` over the traced slice's ``frame`` spans, or None."""
    return stats.per_item(total, len(named(records(), "frame")))
