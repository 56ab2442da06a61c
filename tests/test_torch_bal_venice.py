"""The BAL photo collection (``bal_venice``) through the flat
``iterative_schur`` engine, on the CPU at small sizes in float64.

The benchmark's photo-collection generator
(``portbench/reference/generator_bal_collection.py``): counts, track
lengths, tracks that are not runs of consecutive cameras, determinism by
seed.  Its reference (``portbench/reference/lsq_bal_collection.py``)
against ``lsq_bal``'s step.  ``auto`` resolving to ``iterative_schur`` on
a collection, the engine's first step against the reference's exact step,
a float64 solve at the reference's optimum, the engine's spans and the
sizes its root ``solve`` span carries, the flat PCG's byte bound counted
by hand, the ``flat_pcg_roofline`` reader on synthetic records, and whole
runs of the ``bal_venice.cold`` cell (sound, under each fault and as its
bfloat16 control).  The ``gpu`` case (skipped without a card) holds the
device spans of a captured solve.  The file imports neither jax nor
rsba_tpu (from the repo root):

    python -m pytest --noconftest -o addopts= tests/test_torch_bal_venice.py
"""
import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import manifest, roofline, roofline_flat_pcg, run
from portbench.kinds import solve_bal, solve_bal_collection
from portbench.record import Run
from portbench.reference import generator_bal_collection as gen
from portbench.reference import lsq_bal, lsq_bal_collection
from portbench.tools import faults
from rsba_tpu_torch.solver import SolverOptions, lm, lm_device
from rsba_tpu_torch.utils import trace

torch.set_num_threads(2)
BENCH = manifest.load()
SEED = 2**31 + 43


def _generator(n_poses=12, n_points=400, half_window=3) -> dict:
    p = dict(manifest.config(BENCH, "bal_venice")["generator"])
    p.update(n_poses=n_poses, n_points=n_points,
             track_half_window=half_window)
    return p


def _small(seed=5, **kw):
    """(scene, reference data, the program's float64 problem and start)."""
    sc = gen.make_scene(_generator(**kw), seed)
    problem, params = solve_bal._program_inputs(
        solve_bal._host_inputs(sc, np.float64), "cpu")
    return sc, lsq_bal.Data.of(sc, "cpu"), problem, params


def _ref_params(params) -> dict:
    return lsq_bal.params_on({f: getattr(params, f) for f in
                              ("q", "c", "intr", "points")}, "cpu")


# --- the generator -------------------------------------------------------

@pytest.mark.parametrize("seed", [1, 2**32 - 3])
def test_tracks_lengths_and_cameras(seed):
    """Track lengths: track_min + a geometric draw, capped; every camera
    within the half-window of its centre on the ring (wrapping round),
    none twice in a track; and tracks that are not consecutive runs."""
    p = _generator(n_poses=200, n_points=4000, half_window=50)
    cam, point = gen.tracks(np.random.RandomState(seed), p)
    k = np.bincount(point, minlength=p["n_points"])
    g = p["track_geometric_p"]
    assert k.min() >= p["track_min"] and k.max() <= p["track_max"]
    assert abs(k.mean() - (p["track_min"] + (1 - g) / g)) < 0.15
    assert np.all(np.diff(point) >= 0)
    gaps, wraps = 0, 0
    for j in range(200):
        c = cam[point == j]
        assert len(np.unique(c)) == len(c)
        # the shortest arc of the ring that holds them spans at most 2h
        ring_gaps = np.diff(np.append(c, c[0] + p["n_poses"]))
        assert p["n_poses"] - ring_gaps.max() <= 100
        gaps += int(np.any(np.diff(c) > 1))
        wraps += int(c.max() - c.min() > 100)
    assert gaps > 150 and wraps > 0


def test_scene_counts_and_determinism():
    p = _generator()
    a = gen.make_scene(p, 7)
    b = gen.make_scene(p, 7)
    c = gen.make_scene(p, 8)
    assert (a.n_poses, a.n_points, a.intr.shape) == (12, 400, (12, 9))
    m = a.mask > 0
    assert a.uv.shape[0] % p["pad_to"] == 0 and 400 < a.n_valid
    assert a.n_valid == int(m.sum()) and not a.mask[~m].any()
    np.testing.assert_array_equal(a.intr_idx, a.pose_a)
    for f in ("uv", "pose_a", "point", "mask"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_array_equal(a.start["intr"], b.start["intr"])
    assert not np.array_equal(a.point, c.point)
    assert a.pose_free[0] == 0 and a.pose_free[1:].all()
    np.testing.assert_array_equal(a.start["q"][0], a.gt["q"][0])


def test_generator_refuses_other_problems():
    p = _generator()
    p["rolling_shutter"] = True
    with pytest.raises(ValueError):
        gen.make_scene(p, 0)
    with pytest.raises(ValueError):
        gen.tracks(np.random.RandomState(0),
                   _generator(n_poses=6, half_window=3))


# --- the reference ---------------------------------------------------------

def test_grouped_reference_matches_lsq_bal():
    """The point-group step and gain equal ``lsq_bal``'s padded ones: the
    step at λ = 1e-4 to 1e-10 of its largest entry (readings 7e-12), the
    gain to 1e-10 (5e-12)."""
    sc, d, _, _ = _small(seed=3)
    p = lsq_bal.params_on(sc.start, "cpu")
    ne = lsq_bal._normal_equations(d, p)
    a = lsq_bal._step(d, ne, lsq_bal._point_slots(d), 1e-4)
    b = lsq_bal_collection._step(d, ne, lsq_bal_collection._point_groups(d),
                                 1e-4)
    x = torch.cat([a[0], a[1].reshape(-1)])
    y = torch.cat([b[0], b[1].reshape(-1)])
    assert float((x - y).abs().max()) <= 1e-10 * float(x.abs().max())
    ga = lsq_bal.gauss_newton_gain(d, p)["gain"]
    gb = lsq_bal_collection.gauss_newton_gain(d, p)["gain"]
    assert gb == pytest.approx(ga, rel=1e-10)


# --- the engine --------------------------------------------------------------

def test_auto_resolves_to_iterative_schur():
    """Each camera with its own intrinsics rules the band plan out."""
    _, _, problem, _ = _small(seed=4)
    fns = lm.make_solver_fns(problem, SolverOptions())
    assert fns["engine"] == ("iterative_schur", "torch-flat")
    assert lm.rebindable(problem, SolverOptions())


def test_first_step_matches_reference_exact_step():
    """With CG run to Dc passes at η 1e-12, one step at radius 1e4 (λ =
    1e-4 of the diagonal in both) is the reference's damped Gauss-Newton
    step to 1e-8 of its largest entry."""
    sc, d, problem, params = _small(seed=6)
    opts = SolverOptions(max_cg_iterations=9 * sc.n_poses + 10,
                         cg_eta=1e-12)
    fns = lm.make_solver_fns(problem, opts)
    dx, predicted, iters = fns["solve_step"](fns["prepare"](params), 1e4)
    p = _ref_params(params)
    dc, dxp = lsq_bal_collection._step(
        d, lsq_bal._normal_equations(d, p),
        lsq_bal_collection._point_groups(d), 1e-4)
    want = torch.cat([dc, dxp.reshape(-1)])
    assert float((dx - want).abs().max()) <= 1e-8 * float(want.abs().max())
    assert float(predicted) > 0 and 0 < int(iters) <= opts.max_cg_iterations


def test_float64_solve_reaches_the_reference_optimum():
    """Through ``auto`` and the device loop (eager on the CPU): CONVERGENCE
    at the reference's optimal cost to 1e-9."""
    sc, d, problem, params = _small(seed=9)
    _, best = lsq_bal_collection.optimum(d, lsq_bal.params_on(sc.gt, "cpu"))
    x, s = lm.solve(problem, params,
                    SolverOptions(max_cg_iterations=200, cg_eta=1e-10,
                                  function_tolerance=1e-12,
                                  gradient_tolerance=1e-14,
                                  parameter_tolerance=1e-14))
    lm_device.engines.clear()
    assert (s.linear_solver, s.evaluator) == ("iterative_schur",
                                              "torch-flat+device_loop")
    assert s.termination == "CONVERGENCE"
    assert abs(s.final_cost - best["cost"]) <= 1e-9 * best["cost"]
    assert lsq_bal_collection.gauss_newton_gain(
        d, _ref_params(x))["gain"] <= 1e-9 * best["cost"]


# --- spans ------------------------------------------------------------------

class _Event:
    """A stand-in for a timing event recorded inside a capture."""

    def __init__(self, **kw):
        pass

    def record(self):
        pass

    def elapsed_time(self, end):
        return 1.0


def test_traced_engine_records_plan_and_device_spans(monkeypatch):
    """Under a CPU profiler the flat plan's span carries the engine's
    sizes; with a capture stood in for, prepare opens ``evaluate`` and a
    step ``reduced_system`` and ``pcg``."""
    sc, _, problem, params = _small()
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        fns = lm.make_solver_fns(problem, SolverOptions())
        with monkeypatch.context() as mp:
            mp.setattr(torch.cuda, "is_available", lambda: True)
            mp.setattr(torch.cuda, "is_current_stream_capturing",
                       lambda: True)
            mp.setattr(torch.cuda, "Event", _Event)
            fns["solve_step"](fns["prepare"](params), 1e4)
            pairs = trace.captured()
    recs = trace.records()
    trace.clear()
    assert [(n, inner) for n, inner, _, _ in pairs] == [
        ("evaluate", None), ("reduced_system", None), ("pcg", None)]
    engine, = [r for r in recs if r["name"] == "plan.engine"]
    P = sc.n_poses
    assert engine["attrs"] == {
        "Dc": 9 * P, "M": sc.n_points, "pairs": engine["attrs"]["pairs"],
        "e_bytes": 0}


def test_solve_span_carries_pass_sizes_on_a_miss_and_a_hit():
    """The root ``solve`` span of a traced ``iterative_schur`` solve holds
    what a pass of its PCG reads, whether the engine was built (a miss,
    with a ``plan.engine`` span) or found in the cache (a hit, without)."""
    sc, _, problem, params = _small()
    options = SolverOptions(max_iterations=2)
    lm_device.engines.clear()
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            lm.solve(problem, params, options)
    recs = trace.records()
    trace.clear()
    lm_device.engines.clear()
    roots = [r for r in recs if r["name"] == "solve" and r["parent"] is None]
    assert [r["attrs"]["engine_cache"] for r in roots] == ["miss", "hit"]
    plans = [r["request"] for r in recs if r["name"] == "plan.engine"]
    assert plans == [roots[0]["id"]]
    P = sc.n_poses
    for r in roots:
        assert {k: r["attrs"][k] for k in
                ("N", "M", "P", "n_intr", "ni", "itemsize")} == {
            "N": sc.uv.shape[0], "M": sc.n_points, "P": P, "n_intr": P,
            "ni": 3, "itemsize": 8}


@pytest.mark.gpu
def test_captured_iterative_schur_solve_leaves_its_device_spans():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    sc = gen.make_scene(_generator(n_poses=60, n_points=20000,
                                   half_window=10), 1, "cuda")
    problem, params = solve_bal._program_inputs(
        solve_bal._host_inputs(sc, np.float32), "cuda")
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]):
        _, s = lm.solve(problem, params, SolverOptions())
        torch.cuda.synchronize()
    recs = trace.records()
    trace.clear()
    lm_device.engines.clear()
    assert s.termination == "CONVERGENCE"
    assert s.linear_solver == "iterative_schur"
    by_id = {r["id"]: r for r in recs}
    dev = lambda n: [r for r in recs  # noqa: E731
                     if r["device"] and r["name"] == n]
    attempts, prepares = dev("attempt"), dev("prepare")
    assert len(attempts) >= s.num_iterations and prepares
    for name, parent, count in (("reduced_system", "solve_step", attempts),
                                ("pcg", "solve_step", attempts),
                                ("evaluate", "prepare", prepares)):
        got = dev(name)
        assert len(got) == len(count), name
        assert all(by_id[r["parent"]]["name"] == parent for r in got)
        assert all(r["seconds"] > 0 for r in got)
    total = lambda n: sum(r["seconds"] for r in dev(n))  # noqa: E731
    assert total("reduced_system") + total("pcg") <= total("solve_step")
    assert total("evaluate") <= total("prepare")


# --- the bound and its reader -----------------------------------------------

def test_flat_pcg_bound_on_a_problem_counted_by_hand():
    """N = 5 observations, M = 2 points, P = 3 poses, K = 3 intrinsics of
    ni = 3, float32: 4·5·2·12 + 4·5·3 + 4·(9·2 + 36·3 + 9·3 + 5·27 + 3·2)
    = 1,716 bytes a pass; at Venice's size 588,562,656 bytes, 0.176 ms at
    3.35 TB/s."""
    assert roofline_flat_pcg.bytes_per_pass(5, 2, 3, 3, 4) == 1716
    assert roofline_flat_pcg.bound_s(5, 2, 3, 3, 4, 10) == pytest.approx(
        10 * 1716 / 3.35e12)
    venice = (5001984, 993923, 1778, 1778, 4)
    assert roofline_flat_pcg.bytes_per_pass(*venice) == 588562656
    assert roofline_flat_pcg.bound_s(*venice, 100) == pytest.approx(
        100 * 588562656 / roofline.PEAK_BYTES_S)


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


SIZES = {"N": 5001984, "M": 993923, "P": 1778, "n_intr": 1778, "ni": 3,
         "itemsize": 4}


def _flat_solves(sizes=SIZES):
    """Two profiled solves whose root spans carry the engine's sizes, the
    first a cache miss with its plan, the second a hit, each with two
    attempts with a ``pcg`` device span of 0.3 and 0.4 s."""
    r = _Records()
    for cached in ("miss", "hit"):
        solve = r.add("solve", seconds=2.0, engine_cache=cached, **sizes)
        if cached == "miss":
            plan = r.add("plan", solve)
            r.add("plan.engine", plan, Dc=16002, pairs=1, e_bytes=0)
        for s in (0.3, 0.4):
            host = r.add("loop.attempt", solve, 0.5)
            att = r.add("attempt", host, 0.45, device=True)
            step = r.add("solve_step", att, 0.42, device=True)
            r.add("pcg", step, s, device=True)
    return r.recs


def test_flat_pcg_roofline_reader(monkeypatch):
    monkeypatch.setattr(trace, "records", _flat_solves)
    run_ = Run(kind="solve_bal_collection",
               solves=[{"cg_iters": 150}, {"cg_iters": 50}, {"cg_iters": 9}])
    want = 100 * 200 * 588562656 / roofline.PEAK_BYTES_S / 1.4
    assert run.read_metric("flat_pcg_roofline", run_) == pytest.approx(want)
    assert run.read_metric("pcg_ms_per_attempt", run_) == pytest.approx(350)


def test_flat_pcg_roofline_reader_without_sizes(monkeypatch):
    """Root spans without the sizes (another engine, or a program that
    does not record them) or no span at all read as nothing."""
    run_ = Run(kind="solve_bal_collection", solves=[{"cg_iters": 150}])
    monkeypatch.setattr(trace, "records", lambda: _flat_solves({}))
    assert run.read_metric("flat_pcg_roofline", run_) is None
    monkeypatch.setattr(trace, "records", lambda: [])
    assert run.read_metric("flat_pcg_roofline", run_) is None


# --- whole runs of the cell ------------------------------------------------

@pytest.fixture
def one_problem_pool(monkeypatch):
    """The cell's traffic with a pool of one problem: the same kind and
    check at a third of the set-up."""
    traffic = manifest.traffic
    monkeypatch.setattr(manifest, "traffic",
                        lambda n: dict(traffic(n), pool_seeds=[1]))
    lm_device.engines.clear()
    yield
    lm_device.engines.clear()


def _cell_run(control="none"):
    """The cell at 12 cameras and 300 points; 25 attempts (pool seed 1
    converges in 6) keep a faulty solve that never converges short."""
    cfg = manifest.config(BENCH, "bal_venice")
    cfg["generator"].update(n_poses=12, n_points=300, track_half_window=3)
    cfg["solver"]["max_iterations"] = 25
    return run.execute("bal_venice.cold", SEED, 0.2, False, device="cpu",
                       cfg=cfg, control=control)


def test_sound_run_is_correct(one_problem_pool):
    """float32 solves, each in CONVERGENCE, within the cell's limits."""
    out = _cell_run()
    assert out["correct"], out["check"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"solve_s", "setup_s"}


@pytest.mark.parametrize("fault,number", [("unchanged", "gn_gain"),
                                          ("half", "gn_gain"),
                                          ("altered", "cost_gap")])
def test_fault_is_not_correct(one_problem_pool, monkeypatch, fault, number):
    faults.plant("solve", fault, monkeypatch.setattr)
    out = _cell_run()
    assert not out["correct"]
    c = out["check"][number]
    assert c["value"] > c["limit"], out["check"]


def test_control_in_bfloat16_is_not_correct(one_problem_pool):
    out = _cell_run(control="bf16")
    assert not out["correct"]
    for n in ("gn_gain", "cost_gap", "rmse_gap"):
        assert out["check"][n]["value"] > out["check"][n]["limit"], n


def test_traced_slice_finds_its_engines_cached():
    """Before a traced window the kind solves the slice's problems once
    with tracing on and drops their spans: a traced request then hits
    the cache, as the window's untraced requests do."""
    cfg = manifest.config(BENCH, "bal_venice")
    cfg["generator"] = _generator()
    cfg["dtype"] = "float64"
    cfg["solver"] = dict(cfg["solver"], max_iterations=2)
    traffic = dict(manifest.traffic("cold_bal_collection"), pool_seeds=[1])
    lm_device.engines.clear()
    st = solve_bal_collection.setup(cfg, traffic, SEED, "cpu", "none")
    solve_bal_collection._warm_traced(st)
    assert trace.records() == []
    with profile(activities=[ProfilerActivity.CPU]):
        lm.solve(*solve_bal._program_inputs(st.host[0], "cpu"), st.options)
    root, = [r for r in trace.records()
             if r["name"] == "solve" and r["parent"] is None]
    trace.clear()
    lm_device.engines.clear()
    assert root["attrs"]["engine_cache"] == "hit"


class _Slice:
    """A tracer's start and stop without a profiler (the real one needs
    a card)."""
    enabled = True

    def __init__(self):
        self.active = self.done = False

    def span(self, name):
        return contextlib.nullcontext()

    def start(self):
        self.active = self.active or not self.done

    def stop(self):
        self.done, self.active = self.done or self.active, False


def test_window_shorter_than_the_traced_slice_closes_the_profiler():
    """One solve that outlasts the window ends it before the slice's
    second solve: the kind still closes the profiler, so that the run's
    line has the slice's busy and window times."""
    cfg = manifest.config(BENCH, "bal_venice")
    cfg["generator"] = _generator()
    cfg["dtype"] = "float64"
    cfg["solver"] = dict(cfg["solver"], max_iterations=2)
    traffic = dict(manifest.traffic("cold_bal_collection"), pool_seeds=[1])
    assert traffic["trace_solves"] == 2
    lm_device.engines.clear()
    st = solve_bal_collection.setup(cfg, traffic, SEED, "cpu", "none")
    tracer, out = _Slice(), Run(kind="solve_bal_collection")
    solve_bal_collection.window(st, 0.0, out, tracer)
    trace.clear()
    lm_device.engines.clear()
    assert len(out.solves) == 1 and out.solves[0]["traced"]
    assert tracer.done and not tracer.active


def test_new_benchmark_modules_load_no_jax():
    """The new references import nothing of the program; the new kinds and
    the reader load no JAX nor the JAX package."""
    import subprocess
    import sys
    probe = ("import importlib, sys\n"
             "for m in sys.argv[1:]: importlib.import_module(m)\n"
             "print(' '.join(sorted({m.split('.')[0] "
             "for m in sys.modules})))")

    def loaded(*mods):
        out = subprocess.run([sys.executable, "-c", probe, *mods],
                             capture_output=True, text=True, check=True,
                             cwd=manifest.ROOT, timeout=300)
        return set(out.stdout.split())
    forbidden = {"jax", "jaxlib", "flax", "rsba_tpu"}
    ref = loaded("portbench.reference.generator_bal_collection",
                 "portbench.reference.lsq_bal_collection",
                 "portbench.roofline_flat_pcg")
    assert not ref & (forbidden | {"rsba_tpu_torch"})
    kind = loaded("portbench.kinds.solve_bal_collection",
                  "portbench.kinds.solve_resolve",
                  "rsba_tpu_torch.solver.pcg")
    assert "portbench" in kind and not kind & forbidden
