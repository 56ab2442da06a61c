"""The readers of the program's own spans, on synthetic records."""
import sys

import pytest

from portbench.record import Run
from portbench.run import read_metric
from rsba_tpu_torch.utils import trace

SOLVE = ("pcg_ms_per_attempt", "reduced_system_ms_per_attempt",
         "residual_pass_ms_per_attempt", "window_plan_ms.solve")
SESSION = ("graph_captures_per_frame", "register_capture_ms_per_frame",
           "triangulate_ms_per_frame")


class _Records:
    """Records as ``utils/trace.py`` keeps them."""

    def __init__(self):
        self.recs = []

    def add(self, name, parent=None, seconds=0.0, device=False, **attrs):
        rid = len(self.recs) + 1
        self.recs.append({
            "name": name, "id": rid,
            "parent": None if parent is None else parent["id"],
            "request": rid if parent is None else parent["request"],
            "start_ns": None if device else 0,
            "end_ns": None if device else int(seconds * 1e9),
            "seconds": seconds, "device": device, "attrs": attrs})
        return self.recs[-1]


def _solves():
    """Two solves: the first split as a traced run splits it (``plan``
    outside ``solve``), the second whole; three attempts in all."""
    r = _Records()
    plan = r.add("plan", seconds=0.3)
    r.add("plan.window", plan, 0.2, NR=1096, W=11, L=10, G=112)
    solve = r.add("solve", seconds=1.0)
    for pcg in (0.004, 0.005):
        host = r.add("loop.attempt", solve, 0.01)
        att = r.add("attempt", host, 0.009, device=True)
        step = r.add("solve_step", att, 0.0065, device=True)
        r.add("reduced_system", step, 0.0018, device=True)
        r.add("pcg", step, pcg, device=True)
        r.add("residual_pass", att, 0.0022, device=True)
    solve = r.add("solve", seconds=1.0)
    plan = r.add("plan", solve, 0.3)
    r.add("plan.window", plan, 0.1)
    host = r.add("loop.attempt", solve, 0.01)
    att = r.add("attempt", host, 0.009, device=True)
    step = r.add("solve_step", att, 0.0065, device=True)
    r.add("reduced_system", step, 0.0015, device=True)
    r.add("pcg", step, 0.006, device=True)
    r.add("residual_pass", att, 0.0023, device=True)
    return r.recs


def _frames():
    """Four frames: registration captures in frames 0, 1 and 3 (two in
    frame 3, one through RANSAC), a BA's capture in frame 2."""
    r = _Records()
    for f, caps in enumerate(((0.15,), (0.16,), (), (0.1, 0.12))):
        frame = r.add("frame", seconds=0.3, frame=f, matches=1000)
        reg = r.add("register", frame, 0.2)
        for i, c in enumerate(caps):
            inner = r.add("register.ransac" if i else "register.prior",
                          reg, c + 0.01)
            solve = r.add("solve", inner, c)
            r.add("loop.capture", solve, c)
        r.add("triangulate", frame, 0.004 * (f + 1), new_points=3)
        if f == 2:
            ba = r.add("ba", frame, 0.09)
            solve = r.add("solve", ba, 0.08)
            r.add("loop.capture", solve, 0.05)
    return r.recs


@pytest.fixture
def records(monkeypatch):
    def use(recs):
        monkeypatch.setattr(trace, "records", lambda: list(recs))
    return use


def test_solve_readers(records):
    records(_solves())
    run = Run(kind="solve")
    assert read_metric("pcg_ms_per_attempt", run) == pytest.approx(5.0)
    assert read_metric("reduced_system_ms_per_attempt", run) == \
        pytest.approx(1.7)
    assert read_metric("residual_pass_ms_per_attempt", run) == \
        pytest.approx((0.0022 * 2 + 0.0023) / 3 * 1e3)
    assert read_metric("window_plan_ms.solve", run) == pytest.approx(150.0)
    for name in SESSION:
        assert read_metric(name, run) is None


def test_session_readers(records):
    records(_frames())
    run = Run(kind="session")
    assert read_metric("graph_captures_per_frame", run) == 5 / 4
    assert read_metric("register_capture_ms_per_frame", run) == \
        pytest.approx(1e3 * (0.15 + 0.16 + 0.1 + 0.12) / 4)
    assert read_metric("triangulate_ms_per_frame", run) == \
        pytest.approx(1e3 * 0.004 * 10 / 4)
    for name in SOLVE:
        assert read_metric(name, run) is None


def test_no_records_read_as_nothing(records):
    records([])
    for name in SOLVE + SESSION:
        assert read_metric(name, Run(kind="solve")) is None


def test_a_program_without_spans_reads_as_nothing(monkeypatch):
    """The parent commit's program has no ``utils/trace.py``."""
    import rsba_tpu_torch.utils
    monkeypatch.delattr(rsba_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "rsba_tpu_torch.utils.trace", None)
    with pytest.raises(ImportError):
        from rsba_tpu_torch.utils import trace as _  # noqa: F401
    for name in SOLVE + SESSION:
        assert read_metric(name, Run(kind="session")) is None
