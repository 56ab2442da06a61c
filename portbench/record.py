"""What one run measured, handed to the metric readers."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Run:
    kind: str
    setup_s: float = 0.0
    #: wall of the measured window: from the first request's start to the
    #: last completed request's end
    window_s: float = 0.0
    #: torch.cuda.max_memory_allocated over the window (peak reset after
    #: set-up)
    peak_window_bytes: int = 0
    #: one dict per solve or per frame of the window
    solves: list = dataclasses.field(default_factory=list)
    frames: list = dataclasses.field(default_factory=list)
    failed: int = 0
    #: counts taken over the profiled slice (traced runs)
    counters: dict = dataclasses.field(default_factory=dict)
    #: ``trace.Tracer.summary()`` of the profiled slice (traced runs)
    trace: Optional[dict] = None

    @property
    def attempted(self) -> int:
        return len(self.solves) + len(self.frames)
