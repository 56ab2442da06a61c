"""Spans at the program's layer boundaries, on the profiler's clock.

Tracing is on exactly while a ``torch.profiler`` records in the calling
thread (``torch.autograd._profiler_enabled()``): a profiled run of a
benchmark, the CLI's ``--profile-dir``, ``tools.profile_loop``'s profiled
window.  There is no other switch.

``span(name, **attrs)`` times a stretch of host work.  It always takes
two ``time.perf_counter()`` readings and exposes ``.seconds``, which the
program's own timed fields read (``Summary``'s phase times, a session
report's ``wall_s``, the capture seconds of the device loop), so that an
interval is timed once.  While tracing is on it also opens
``torch.profiler.record_function("rsba." + name)``, which puts the span
on the profiler's timeline beside the device's operations, and keeps a
record in memory: its name, its start and end from ``time.time_ns()``
(the profiler's clock), its id, its parent's id, the id of its root span
as the request id, and ``attrs``.  Counts are ``attrs`` of the span at
their boundary, or the number of spans of a name.

``device_span(name)`` times a stretch of device work inside a CUDA graph.
Only while a graph is being captured with tracing on, it records a pair
of timing events (``external=True``, so that they become nodes of the
graph) around the work and hands the pair to whoever takes
``captured()`` after the capture; the device loop resolves the pairs
after each replay, at a read-back it makes anyway, into device records
(``device=True``, ``seconds`` from the events, no host times).  Outside a
capture, on the CPU or with tracing off it does nothing, so a graph
captured with tracing off is the same graph, node for node.

``records()`` returns the records kept so far, ``clear()`` drops them.
"""
from __future__ import annotations

import itertools
import threading
import time

import torch

PREFIX = "rsba."

_records: list = []
_ids = itertools.count(1)


class _Local(threading.local):
    """Each thread's open spans."""

    def __init__(self):
        self.stack = []     # records of the open host spans
        self.pairs = []     # device spans' pairs of the graph in capture
        self.depth = []     # indices in ``pairs`` of the open device spans


_local = _Local()


def enabled() -> bool:
    """Whether tracing is on in the calling thread: a profiler records."""
    return torch.autograd._profiler_enabled()


def _new_record(name: str, parent, attrs: dict, device: bool) -> dict:
    rid = next(_ids)
    rec = {"name": name, "id": rid,
           "parent": None if parent is None else parent["id"],
           "request": rid if parent is None else parent["request"],
           "start_ns": None, "end_ns": None, "seconds": None,
           "device": device, "attrs": attrs}
    _records.append(rec)
    return rec


class span:
    """``with span(name, **attrs) as s: ...``; then ``s.seconds``.

    ``s.elapsed()`` reads the seconds since the span opened, and
    ``s.set(**attrs)`` adds attributes known only inside it."""

    __slots__ = ("name", "attrs", "seconds", "record", "_t0", "_rf")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs
        self.seconds = None
        self.record = None
        self._rf = None

    def __enter__(self) -> "span":
        if enabled():
            stack = _local.stack
            self.record = _new_record(self.name,
                                      stack[-1] if stack else None,
                                      self.attrs, False)
            stack.append(self.record)
            self._rf = torch.profiler.record_function(PREFIX + self.name)
            self._rf.__enter__()
            self.record["start_ns"] = time.time_ns()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = time.perf_counter() - self._t0
        rec = self.record
        if rec is not None:
            rec["end_ns"] = time.time_ns()
            rec["seconds"] = self.seconds
            self._rf.__exit__(*exc)
            stack = _local.stack
            if stack and stack[-1] is rec:
                stack.pop()

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)


class device_span:
    """``with device_span(name): ...`` times the enclosed device work in
    the graph being captured (see the module's docstring); a no-op
    anywhere else."""

    __slots__ = ("name", "pair")

    def __init__(self, name: str):
        self.name = name
        self.pair = None

    def __enter__(self) -> "device_span":
        if (enabled() and torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing()):
            start = torch.cuda.Event(enable_timing=True, external=True)
            start.record()
            # (name, index of the enclosing pair or None, start, end)
            self.pair = [self.name,
                         _local.depth[-1] if _local.depth else None,
                         start, None]
            _local.pairs.append(self.pair)
            _local.depth.append(len(_local.pairs) - 1)
        return self

    def __exit__(self, *exc) -> None:
        if self.pair is not None:
            end = torch.cuda.Event(enable_timing=True, external=True)
            end.record()
            self.pair[3] = end
            _local.depth.pop()


def captured() -> list:
    """Take the event pairs recorded since the last call: those of one
    captured graph, in the order they opened."""
    pairs = _local.pairs
    _local.pairs, _local.depth = [], []
    return pairs


def resolve(pairs: list, parent, totals: dict = None,
            into: dict = None) -> list:
    """Device records of one replay of a graph whose ``captured()`` pairs
    are ``pairs``, once the replay has completed (after a read-back that
    follows it on the stream).  The outermost pairs become children of
    the host record ``parent``, the others of the pair that encloses
    them; with ``into``, a device record of an earlier graph, the
    outermost pair adds its seconds to that record instead and its
    children hang from it.  ``totals``, where given, gains each pair's
    seconds under its name.  Returns the records in the pairs' order;
    makes nothing while tracing is off."""
    if not pairs or not enabled():
        return []
    out = []
    for name, inner, start, end in pairs:
        seconds = 1e-3 * start.elapsed_time(end)
        if inner is None and into is not None:
            rec = into
            rec["seconds"] += seconds
        else:
            rec = _new_record(name, parent if inner is None else out[inner],
                              {}, True)
            rec["seconds"] = seconds
        out.append(rec)
        if totals is not None:
            totals[name] = totals.get(name, 0.0) + seconds
    return out


def records() -> list:
    """The records kept so far, in the order their spans opened."""
    return list(_records)


def clear() -> None:
    """Drop the records kept so far."""
    _records.clear()
