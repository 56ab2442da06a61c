"""Spans around the calls into each layer, and the device trace of a
bounded slice of a traced run.

``Tracer.span(name)`` marks a stretch of host work (``plan``, ``solve``,
``register``, ``triangulate``, ``ba``) in the profiler's timeline while a
slice is being profiled, and costs nothing otherwise.  ``start`` and
``stop`` bound the profiled slice; ``summary`` reads the profiler's raw
events once the window has closed (every device operation, also those
that a kernel library launches outside PyTorch's operators): the
device's busy time (the union of its operations' intervals) against the
slice's length, launches and device time by operation name, and the
longest idle stretches, each named by the innermost span it fell in.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict

import torch

from . import stats

PREFIX = "portbench."
WINDOW = PREFIX + "window"


class Tracer:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._prof = None
        self._window = None
        self.done = False

    @property
    def active(self) -> bool:
        return self._prof is not None

    @contextlib.contextmanager
    def span(self, name: str):
        if self._prof is None:
            yield
        else:
            with torch.profiler.record_function(PREFIX + name):
                yield

    def start(self) -> None:
        """Begin the profiled slice (once a run, and only when enabled)."""
        if not self.enabled or self.done or self._prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()

    def stop(self) -> None:
        if self._prof is None or self.done:
            return
        torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.done = True

    def summary(self, top: int = 10):
        """What the slice's trace says, or None if nothing was profiled."""
        if not self.done:
            return None
        events = self._prof.profiler.kineto_results.events()
        self._prof = None
        cuda = torch.autograd.DeviceType.CUDA
        lo = hi = None
        spans, device = [], []
        for e in events:
            name, on_card = e.name(), e.device_type() == cuda
            a = e.start_ns() * 1e-9
            b = a + e.duration_ns() * 1e-9
            if name.startswith(PREFIX):
                # a span: its host range (its copy on the device's
                # timeline is an annotation, no device operation)
                if on_card:
                    continue
                if name == WINDOW:
                    lo, hi = a, b
                else:
                    spans.append((a, b, name[len(PREFIX):]))
            elif on_card and not e.is_user_annotation():
                device.append((a, b, name))
        if lo is None:
            return None
        inside = [(max(a, lo), min(b, hi), n) for a, b, n in device
                  if b > lo and a < hi]
        by_name = defaultdict(lambda: [0, 0.0])
        for a, b, n in inside:
            by_name[n][0] += 1
            by_name[n][1] += b - a
        busy = stats.union_length([(a, b) for a, b, _ in inside])

        def label(t):
            best = None
            for a, b, n in spans:
                if a <= t <= b and (best is None or b - a < best[1] - best[0]):
                    best = (a, b, n)
            return best[2] if best else "host"

        idle = stats.gaps([(a, b) for a, b, _ in inside], lo, hi)[:top]
        return {"busy_s": busy, "window_s": hi - lo,
                "ops": dict(by_name),
                "device_ops": sorted(([n, v[1]] for n, v in by_name.items()),
                                     key=lambda x: -x[1])[:top],
                "idle_gaps": [[label(0.5 * (a + b)), b - a]
                              for a, b in idle]}
