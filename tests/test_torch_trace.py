"""Spans inside the program (``rsba_tpu_torch/utils/trace.py``).

On the CPU: tracing off makes no record, no ``record_function`` and no
CUDA event; under a CPU ``torch.profiler`` the spans nest, carry their
parent and request ids and their attributes, sit on the profiler's
clock, and a tiny solve and a tiny session leave the spans of each
layer, whose seconds are the program's own timed fields.  The ``gpu``
cases (skipped without a card) hold the device spans of a captured
solve.  The file imports neither jax nor rsba_tpu (from the repo root):

    python -m pytest --noconftest -o addopts= tests/test_torch_trace.py
"""
import contextlib
import re
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from rsba_tpu_torch import SfmSession
from rsba_tpu_torch.geometry import Loss
from rsba_tpu_torch.kernels import band_pcg
from rsba_tpu_torch.problem import synthetic, types
from rsba_tpu_torch.solver import SolverOptions, lm, lm_device, solve, window
from rsba_tpu_torch.tools import pipeline_gpu
from rsba_tpu_torch.utils import trace

torch.set_num_threads(2)

SOLVE_SPANS = {"solve", "plan", "plan.window", "plan.engine",
               "solve.finish", "band_pcg.plan"}


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _tiny(device="cpu", dtype=torch.float64):
    return synthetic.make_ba_problem(
        dtype=dtype, device=device,
        **chip_smoke.fixtures()["flagship_slerp_dist_huber"])


def _by_id(recs):
    return {r["id"]: r for r in recs}


def _names(recs, device=False):
    return Counter(r["name"] for r in recs if r["device"] == device)


@pytest.fixture
def counted(monkeypatch):
    """Calls of ``record_function`` and of ``torch.cuda.Event``."""
    calls = Counter()
    rf, event = torch.profiler.record_function, torch.cuda.Event

    def count_rf(*a, **k):
        calls["record_function"] += 1
        return rf(*a, **k)

    def count_event(*a, **k):
        calls["event"] += 1
        return event(*a, **k)
    monkeypatch.setattr(torch.profiler, "record_function", count_rf)
    monkeypatch.setattr(torch.cuda, "Event", count_event)
    return calls


@pytest.fixture(scope="module")
def traced_solves():
    """A tiny solve through each loop under a CPU profiler: (loop,
    summary, the records it left, the profile's raw events)."""
    ba = _tiny()
    out = {}
    for loop in ("off", "auto"):
        trace.clear()
        with _cpu_profile() as prof:
            _, s = solve(ba.problem, ba.params0,
                         SolverOptions(max_iterations=30, device_loop=loop))
        out[loop] = (s, trace.records(),
                     prof.profiler.kineto_results.events())
    trace.clear()
    return out


@pytest.fixture(scope="module")
def traced_session():
    """Six frames of a tiny video through an ``SfmSession`` under a CPU
    profiler: (reports, records)."""
    ba, frames = pipeline_gpu.make_sequence(6, 150, device="cpu")
    sess = SfmSession(ba.params_gt.intr[0].numpy(), ba.problem.model,
                      ba.image_size, window=8, ba_interval=4,
                      dtype=torch.float32, shape_buckets=True, device="cpu",
                      options=SolverOptions(linear_solver="auto",
                                            max_iterations=25))
    trace.clear()
    with _cpu_profile():
        reports = [sess.add_frame(pid, uv, rows=uv[:, 1])
                   for pid, uv in frames]
    recs = trace.records()
    trace.clear()
    return reports, recs


def test_tracing_off_makes_no_record_nor_event(counted):
    assert not trace.enabled()
    trace.clear()
    with trace.span("outer", a=1) as sp:
        with trace.device_span("inner"):
            pass
    assert sp.seconds >= 0.0 and sp.record is None
    ba = _tiny()
    for loop in ("off", "auto"):
        _, s = solve(ba.problem, ba.params0,
                     SolverOptions(max_iterations=30, device_loop=loop))
        assert s.termination == "CONVERGENCE" and s.total_time > 0
    assert trace.records() == []
    assert trace.captured() == []
    assert counted == Counter()


def test_spans_nest_with_parent_and_request_ids_and_attrs(counted):
    trace.clear()
    with _cpu_profile():
        assert trace.enabled()
        with trace.span("a", x=1) as a:
            with trace.span("b") as b:
                b.set(y=2)
            with trace.span("c"):
                pass
        with trace.span("d"):
            pass
    assert not trace.enabled()
    recs = trace.records()
    assert [r["name"] for r in recs] == ["a", "b", "c", "d"]
    ra, rb, rc, rd = recs
    assert ra["parent"] is None and ra["request"] == ra["id"]
    assert rb["parent"] == rc["parent"] == ra["id"]
    assert rb["request"] == rc["request"] == ra["id"]
    assert rd["parent"] is None and rd["request"] == rd["id"] != ra["id"]
    assert ra["attrs"] == {"x": 1} and rb["attrs"] == {"y": 2}
    assert ra["seconds"] == a.seconds and rb["seconds"] == b.seconds
    assert ra["start_ns"] <= rb["start_ns"] <= rb["end_ns"] <= ra["end_ns"]
    assert not any(r["device"] for r in recs)
    assert counted["record_function"] == 4 and counted["event"] == 0
    trace.clear()
    assert trace.records() == []


def test_records_share_the_profilers_clock(traced_solves):
    """Each record has its ``rsba.<name>`` event in the profile, starting
    within 5 ms of the record's start."""
    for loop, (_, recs, events) in traced_solves.items():
        starts = {}
        for e in events:
            if e.name().startswith(trace.PREFIX):
                starts.setdefault(e.name()[len(trace.PREFIX):],
                                  []).append(e.start_ns())
        seen = Counter()
        for r in recs:
            k = seen[r["name"]]
            seen[r["name"]] += 1
            t = sorted(starts[r["name"]])[k]
            assert abs(t - r["start_ns"]) < 5e6, (loop, r["name"])


def test_a_solve_leaves_the_spans_of_each_layer(traced_solves):
    s, recs, _ = traced_solves["off"]
    names = _names(recs)
    assert set(names) == SOLVE_SPANS | {"lm.prepare", "lm.solve_step",
                                        "lm.cost_decrease"}
    assert names["solve"] == 1 and names["lm.solve_step"] >= s.num_iterations
    root, = [r for r in recs if r["name"] == "solve"]
    ids = _by_id(recs)
    assert all(r["request"] == root["id"] for r in recs)
    assert ids[[r for r in recs if r["name"] == "plan.window"][0]["parent"]][
        "name"] == "plan"
    window, = [r for r in recs if r["name"] == "plan.window"]
    assert set(window["attrs"]) == {"NR", "W", "L", "G", "host_bytes",
                                    "device", "fold_idx", "heavy_idx"}

    s, recs, _ = traced_solves["auto"]
    names = _names(recs)
    assert set(names) == SOLVE_SPANS | {"loop.attempt"}   # eager: no capture
    assert names["loop.attempt"] >= s.num_iterations
    assert not any(r["device"] for r in recs)


def test_band_pcg_plan_and_fold_tables_are_recorded(traced_solves):
    """Every step solve of the banded engine opens ``band_pcg.plan`` with
    the band's shape and the launch plan the card would take first for
    it; ``plan.window`` carries the shapes of both fold tables."""
    ba = _tiny()
    plan = window.build_window_plan(ba.problem)
    P = ba.problem.pose_free.shape[0]
    first = band_pcg.launch_plans(P, plan.W, 8)[0]
    want = dict(P=P, W=plan.W, itemsize=8, ctas=first.ctas,
                poses_per_cta=first.poses_per_cta,
                rows_in_smem=first.rows_in_smem,
                smem_bytes=first.smem_bytes)
    assert plan.heavy_pose.numel()          # a second table to record
    for loop, step in (("off", "lm.solve_step"), ("auto", "loop.attempt")):
        s, recs, _ = traced_solves[loop]
        ids = _by_id(recs)
        plans = [r for r in recs if r["name"] == "band_pcg.plan"]
        assert len(plans) == _names(recs)[step] >= s.num_iterations
        for r in plans:
            assert r["attrs"] == want
            assert ids[r["parent"]]["name"] == step
        rec, = [r for r in recs if r["name"] == "plan.window"]
        assert rec["attrs"]["fold_idx"] == tuple(plan.fold_idx.shape) \
            == (P, plan.fold_idx.shape[1])
        assert rec["attrs"]["heavy_idx"] == tuple(plan.heavy_idx.shape)


def test_summary_times_are_the_spans_seconds(traced_solves):
    for loop, (s, recs, _) in traced_solves.items():
        total = lambda n: sum(r["seconds"] for r in recs  # noqa: E731
                              if r["name"] == n)
        assert s.total_time == total("solve")
        assert 0 < s.preprocessing_time < s.total_time
        if loop == "off":
            assert s.evaluation_time == total("lm.prepare") > 0
            assert s.linear_solver_time == total("lm.solve_step") > 0
        else:       # eager device loop on the CPU: no device spans
            assert s.evaluation_time == s.linear_solver_time == 0.0


def test_a_session_leaves_the_spans_of_each_stage(traced_session):
    reports, recs = traced_session
    ids = _by_id(recs)
    names = _names(recs)
    frames = [r for r in recs if r["name"] == "frame"]
    assert [r["attrs"]["frame"] for r in frames] == list(range(6))
    assert all(r["parent"] is None and r["request"] == r["id"]
               and r["attrs"]["matches"] > 0 for r in frames)
    assert names["bootstrap"] == 1 and names["ba"] >= 1
    assert names["register"] == names["triangulate"] == 4
    assert names["register.prior"] + names["register.ransac"] >= 4
    # every bundle adjustment (the bootstrap's too) plans a window
    assert names["ba.build"] == names["ba.readback"] == names["plan.window"]
    for r in recs:
        if r["name"] in ("register.prior", "register.ransac"):
            assert ids[r["parent"]]["name"] in ("register", "bootstrap")
        if r["name"] == "ba.build":
            assert r["attrs"]["observations"] > 0
            assert ids[r["parent"]]["name"] in ("ba", "bootstrap")
        if r["name"] != "frame":
            assert ids[r["request"]]["name"] == "frame"
    # the session's stage times are the stage spans' seconds
    stages = [(ids[r["parent"]]["attrs"]["frame"], r) for r in recs
              if r["name"] in ("bootstrap", "register", "triangulate", "ba")
              and ids[r["parent"]]["name"] == "frame"]
    assert stages
    for f, r in stages:
        assert reports[f]["wall_s"][r["name"]] == r["seconds"]
        if r["name"] == "triangulate":
            assert r["attrs"]["new_points"] == reports[f]["new_points"]
    assert sum(len(rep["wall_s"]) for rep in reports) == len(stages)


def _config4_shaped(n_points, device="cpu"):
    """Config 4's generator (rolling shutter, SLERP, distortion, tracks of
    10, Huber, 5% outliers) at 21 poses."""
    return synthetic.make_ba_problem(
        n_poses=21, n_points=n_points, track_len=10, rolling_shutter=True,
        rotation_interp="slerp", use_distortion=True,
        loss=Loss("huber", 4.0), outlier_fraction=0.05, pixel_noise=0.5,
        seed=1, dtype=torch.float64, device=device)


def test_window_plan_reads_back_bytes_of_poses_not_observations():
    """``plan.window``'s ``host_bytes``: a few scalars and a count per
    pose, the same for twice the points."""
    read = []
    for n_points in (400, 800):
        problem = _config4_shaped(n_points).problem
        trace.clear()
        with _cpu_profile():
            lm.make_solver_fns(problem, SolverOptions())
        rec, = [r for r in trace.records() if r["name"] == "plan.window"]
        trace.clear()
        n_poses = problem.pose_free.shape[0]
        assert rec["attrs"]["device"] == "cpu"
        # the points of each window base, int64, and a few scalars
        assert 8 * n_poses < rec["attrs"]["host_bytes"] <= 8 * (n_poses + 64)
        read.append(rec["attrs"]["host_bytes"])
    assert read[0] == read[1]


def test_add_grows_the_innermost_open_span(counted):
    trace.add(n=1)                  # tracing off: nothing to grow
    trace.clear()
    with _cpu_profile():
        with trace.span("a", n=1):
            trace.add(n=2)
            with trace.span("b"):
                trace.add(n=3, m=1)
                trace.add(n=4)
    assert [r["attrs"] for r in trace.records()] == [{"n": 3},
                                                     {"n": 7, "m": 1}]
    trace.clear()


# --- on the card ---------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")


def _card_problem():
    """Config 4 at full size, float32.  Since the band PCG kernel an
    attempt is no longer mostly PCG, and the loop's own work outside the
    three spans (the LM update and the state copies, about 0.4 ms an
    attempt under the profiler) is 8% of a full-size attempt, against 14%
    at a tenth of the size."""
    return synthetic.CONFIGS["rs_slerp_robust"](scale=1.0, seed=1,
                                                dtype=torch.float32,
                                                device="cuda")


@pytest.mark.gpu
def test_captured_solve_leaves_device_spans_per_attempt():
    _need_card()
    ba = _card_problem()
    opts = SolverOptions()
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]):
        _, s = solve(ba.problem, ba.params0, opts)
        torch.cuda.synchronize()
    recs = trace.records()
    trace.clear()
    assert s.evaluator == "cuda+device_loop"
    ids = _by_id(recs)
    host = _names(recs)
    dev = _names(recs, device=True)
    assert host["loop.capture"] == 1
    attempts = [r for r in recs if r["device"] and r["name"] == "attempt"]
    assert len(attempts) == host["loop.attempt"] >= s.num_iterations
    assert all(ids[r["parent"]]["name"] == "loop.attempt" for r in attempts)
    assert dev["solve_step"] == dev["residual_pass"] == len(attempts)
    assert dev["pcg"] == dev["reduced_system"] == dev["band_pcg"] \
        == len(attempts)
    assert host["band_pcg.plan"] >= 1
    assert all(ids[r["parent"]]["name"] == "pcg" for r in recs
               if r["device"] and r["name"] == "band_pcg")
    assert 0 < dev["prepare"] <= len(attempts)
    total = lambda n: sum(r["seconds"] for r in recs  # noqa: E731
                          if r["device"] and r["name"] == n)
    parts = total("prepare") + total("solve_step") + total("residual_pass")
    assert 0.9 * total("attempt") <= parts <= total("attempt")
    assert total("pcg") + total("reduced_system") <= total("solve_step")
    assert 0 < total("band_pcg") <= total("pcg")
    assert s.linear_solver_time == pytest.approx(total("solve_step"))
    assert s.evaluation_time == pytest.approx(total("prepare")
                                              + total("residual_pass"))


class _DebugGraph(torch.cuda.CUDAGraph):
    """A graph that keeps its nodes for ``debug_dump``."""
    made = []

    def __init__(self):
        super().__init__(keep_graph=True)
        self.enable_debug_mode()
        _DebugGraph.made.append(self)


def _event_nodes(graphs, tmp_path) -> int:
    """Event-record nodes in the graphs' DOT dumps."""
    n = 0
    for i, g in enumerate(graphs):
        path = tmp_path / f"graph{i}.dot"
        g.debug_dump(str(path))
        n += len(re.findall(r"EVENT_RECORD", path.read_text()))
    return n


@pytest.mark.gpu
def test_graph_captured_with_tracing_off_holds_no_event_node(monkeypatch,
                                                            tmp_path):
    _need_card()
    ba = _tiny(device="cuda")
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _DebugGraph)
    counts = {}
    for traced in (False, True):
        _DebugGraph.made = []
        with (_cpu_profile() if traced else contextlib.nullcontext()):
            _, s = solve(ba.problem, ba.params0,
                         SolverOptions(max_iterations=30))
        assert s.termination == "CONVERGENCE"
        assert len(_DebugGraph.made) == 2
        counts[traced] = _event_nodes(_DebugGraph.made, tmp_path)
    trace.clear()
    assert counts[False] == 0
    assert counts[True] > 0
    assert lm_device._Runner.capture_seconds > 0


@pytest.mark.gpu
def test_window_plan_on_the_card_equals_the_plan_on_the_cpu():
    """Config 4 at full size: the plan built from the problem on the card
    equals, field by field, the plan built from it on the CPU, and reads
    back under 64 KB."""
    _need_card()
    problem = synthetic.CONFIGS["rs_slerp_robust"](
        seed=1, dtype=torch.float32, device="cuda").problem
    want = window.build_window_plan(types.problem_from_numpy(
        problem, device="cpu", dtype=torch.float32))
    trace.clear()
    with _cpu_profile():
        with trace.span("plan.window", host_bytes=0) as sp:
            got = window.build_window_plan(problem)
        torch.cuda.synchronize()
    trace.clear()
    assert 0 < sp.record["attrs"]["host_bytes"] < 64 * 1024
    for f in ("NR", "G", "L", "W", "n_poses", "n_points"):
        assert getattr(got, f) == getattr(want, f), f
    for f in window._ROW_FIELDS + window._FOLD_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.device.type == "cuda" and g.dtype == w.dtype, f
        assert torch.equal(g.cpu(), w), f
