"""Config 2 (``gs_bal``): BAL-style problems, global shutter, every camera
with its own focal length, k1 and k2 optimised, through ``dense_schur``.

On the CPU, at small sizes: the benchmark's frozen generator
(``portbench/reference/generator_bal.py``) against the program's preset;
the dense Schur engine's prepare and one step against the plain float64
reference (``portbench/reference/lsq_bal.py``); a float64 solve at the
reference's optimum and whole runs of the ``gs_bal.cold`` cell (sound,
under each fault, and its bfloat16 control); the engine's spans; the
reduced system's roofline bound on a problem counted by hand; and the new
metric readers on synthetic records.  The ``gpu`` case (skipped without a
card) holds the device spans of a captured solve.  The file imports
neither jax nor rsba_tpu (from the repo root):

    python -m pytest --noconftest -o addopts= tests/test_torch_gs_bal.py
"""
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import manifest, roofline, roofline_bal, run
from portbench.record import Run
from portbench.reference import generator_bal, lsq_bal
from portbench.tools import faults
from rsba_tpu_torch.problem import synthetic
from rsba_tpu_torch.solver import SolverOptions, lm, lm_device
from rsba_tpu_torch.utils import trace

torch.set_num_threads(2)
BENCH = manifest.load()
SEED = 2**31 + 29


def _generator(n_poses, n_points) -> dict:
    p = dict(manifest.config(BENCH, "gs_bal")["generator"])
    p.update(n_poses=n_poses, n_points=n_points)
    return p


def _program(p: dict, seed: int, dtype=torch.float64):
    """The program's problem of generator parameters ``p``."""
    return synthetic.make_ba_problem(
        n_poses=p["n_poses"], n_points=p["n_points"],
        track_len=p["track_len"], use_distortion=p["distortion"],
        per_camera_intrinsics=True, optimize_intrinsics=True,
        pixel_noise=p["pixel_noise"], seed=seed, dtype=dtype, device="cpu",
        pad_to=p["pad_to"])


def _small(seed=5, n_poses=12, n_points=600):
    """A small problem from both generators: (scene, reference data,
    program problem)."""
    p = _generator(n_poses, n_points)
    sc = generator_bal.make_scene(p, seed)
    return sc, lsq_bal.Data.of(sc, "cpu"), _program(p, seed)


def _ref_params(params) -> dict:
    return lsq_bal.params_on({f: getattr(params, f) for f in
                              ("q", "c", "intr", "points")}, "cpu")


# --- the generator -------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 2**32 - 5])
def test_generator_reproduces_program_preset(seed):
    scale = 0.05
    p = _generator(max(int(100 * scale), 4), max(int(50000 * scale), 100))
    sc = generator_bal.make_scene(p, seed)
    ba = synthetic.CONFIGS["gs_bal"](scale=scale, seed=seed,
                                     dtype=torch.float64, device="cpu")
    o = ba.problem.obs
    assert sc.n_valid > 10000
    np.testing.assert_allclose(sc.uv, o.uv.numpy(), rtol=0, atol=1e-9)
    np.testing.assert_array_equal(sc.t, o.t.numpy())
    for f in ("pose_a", "pose_b", "point", "intr_idx", "mask"):
        np.testing.assert_array_equal(getattr(sc, f), getattr(o, f).numpy())
    np.testing.assert_array_equal(sc.pose_free, ba.problem.pose_free.numpy())
    for key, src in (("gt", ba.params_gt), ("start", ba.params0)):
        for f in ("q", "c", "intr", "points"):
            np.testing.assert_allclose(sc.gt[f] if key == "gt"
                                       else sc.start[f],
                                       getattr(src, f).numpy(),
                                       rtol=0, atol=1e-12)
    np.testing.assert_array_equal(sc.intr, sc.gt["intr"])


def test_generator_refuses_other_problems():
    p = _generator(12, 100)
    p["rolling_shutter"] = True
    with pytest.raises(ValueError):
        generator_bal.make_scene(p, 0)


# --- the engine against the reference -------------------------------------

def _reference_blocks(d, p):
    """The reference's normal equations as the program lays them out: B,
    g_c, C, g_x and Eᵀ per point (M, 3, Dc)."""
    B, g_c, C, g_x, E, rows = lsq_bal._normal_equations(d, p)
    A = torch.zeros((d.n_points, 3, d.cam_dim), dtype=torch.float64)
    ip = d.ip[:, None, None].expand(-1, 3, lsq_bal.CAM)
    k = torch.arange(3)[None, :, None].expand_as(ip)
    A.index_put_((ip, k, rows[:, None, :].expand_as(ip)),
                 E.transpose(1, 2), accumulate=True)
    return B, g_c, C, g_x, A


def test_prepare_and_step_match_reference_in_float64():
    """At the perturbed start: the engine's cost, gradient, B, Eᵀ and C,
    Jacobi scaling undone, equal the reference's to 1e-12 of each block's
    largest entry, and one step at radius 1e4 (λ = 1e-4 of the diagonal
    in both) the reference's damped Gauss-Newton step to 1e-9 of its
    largest entry.  Both are float64 sums and solves in other orders: on
    three seeds the blocks differ by at most 2.4e-15 and the step, which
    the damped reduced system's conditioning amplifies, by 5.8e-12."""
    sc, d, ba = _small()
    fns = lm.make_solver_fns(ba.problem,
                             SolverOptions(linear_solver="dense_schur"))
    aux = fns["prepare"](ba.params0)
    p = _ref_params(ba.params0)
    B, g_c, C, g_x, A = _reference_blocks(d, p)
    s_cam, s_pt = aux["s_cam"], aux["s_pt"].reshape(-1, 3)

    def close(got, want):
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-12 * scale

    assert float(aux["cost"]) == pytest.approx(
        lsq_bal.cost_stats(d, p)["cost"], rel=1e-13)
    close(aux["g_cam"] / s_cam, g_c)
    close(aux["g_pt"] / s_pt, g_x)
    close(aux["B"] / (s_cam[:, None] * s_cam[None, :]), B)
    close(aux["A"] / (s_pt[:, :, None] * s_cam[None, None, :]), A)
    close(aux["C"] / (s_pt[:, :, None] * s_pt[:, None, :]), C)

    dx, predicted, _ = fns["solve_step"](aux, 1e4)
    ne = lsq_bal._normal_equations(d, p)
    dc, dxp = lsq_bal._step(d, ne, lsq_bal._point_slots(d), 1e-4)
    want = torch.cat([dc, dxp.reshape(-1)])
    assert float((dx - want).abs().max()) <= 1e-9 * float(want.abs().max())
    assert float(predicted) > 0


def test_float64_solve_reaches_the_reference_optimum():
    """The reference's optimum and the program's float64 solve agree to
    1e-12 of the cost and of the inlier RMSE (on three seeds at most
    4e-15: both reach the same minimum); one reference Gauss-Newton step
    from the program's answer gains under 1e-14 of the cost (readings
    2e-21 to 3e-20), from the start over 10 times the optimal cost."""
    sc, d, ba = _small(seed=9)
    _, best = lsq_bal.optimum(d, lsq_bal.params_on(sc.gt, "cpu"))
    x, s = lm.solve(ba.problem, ba.params0,
                    SolverOptions(linear_solver="dense_schur",
                                  function_tolerance=1e-12,
                                  gradient_tolerance=1e-14,
                                  parameter_tolerance=1e-14))
    assert s.termination == "CONVERGENCE"
    assert abs(s.final_cost - best["cost"]) <= 1e-12 * best["cost"]
    assert s.final_rmse_inlier == pytest.approx(best["rmse_inlier"],
                                                rel=1e-12)
    p = _ref_params(x)
    assert lsq_bal.gauss_newton_gain(d, p)["gain"] <= 1e-14 * best["cost"]
    assert lsq_bal.gauss_newton_gain(
        d, lsq_bal.params_on(sc.start, "cpu"))["gain"] >= 10 * best["cost"]


# --- whole runs of the cell ------------------------------------------------

def _cell_run(control="none"):
    cfg = manifest.config(BENCH, "gs_bal")
    cfg["generator"].update(n_poses=12, n_points=800)
    return run.execute("gs_bal.cold", SEED, 1.0, False, device="cpu",
                       cfg=cfg, control=control)


def test_sound_run_is_correct():
    """float32 solves, each in CONVERGENCE, within the cell's limits."""
    lm_device.engines.clear()
    out = _cell_run()
    lm_device.engines.clear()
    assert out["correct"], out["check"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    # no card, no peak_mem_gib
    assert set(out["metrics"]) == {"solve_s", "setup_s"}


@pytest.mark.parametrize("fault,number", [("unchanged", "gn_gain"),
                                          ("half", "gn_gain"),
                                          ("altered", "cost_gap")])
def test_fault_is_not_correct(monkeypatch, fault, number):
    faults.plant("solve", fault, monkeypatch.setattr)
    lm_device.engines.clear()
    out = _cell_run()
    lm_device.engines.clear()
    assert not out["correct"]
    c = out["check"][number]
    assert c["value"] > c["limit"], out["check"]


def test_control_in_bfloat16_is_not_correct():
    out = _cell_run(control="bf16")
    assert not out["correct"]
    for n in ("gn_gain", "cost_gap", "rmse_gap"):
        assert out["check"][n]["value"] > out["check"][n]["limit"], n


def test_limits_of_the_new_cells():
    for config, kind in (("gs_bal", "solve_bal"), ("rs_video_linear",
                                                    "solve")):
        lim = manifest.limits(config, kind)
        assert set(lim) == {"gn_gain", "cost_gap", "rmse_gap"}
        assert all(v > 0 for v in lim.values())


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
    sizes; with a capture stood in for, prepare opens ``evaluate`` and
    ``assemble`` and a step ``reduced_system`` and ``factor_solve``."""
    sc, d, ba = _small()
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        fns = lm.make_solver_fns(ba.problem,
                                 SolverOptions(linear_solver="dense_schur"))
        with monkeypatch.context() as mp:
            mp.setattr(torch.cuda, "is_available", lambda: True)
            mp.setattr(torch.cuda, "is_current_stream_capturing",
                       lambda: True)
            mp.setattr(torch.cuda, "Event", _Event)
            aux = fns["prepare"](ba.params0)
            fns["solve_step"](aux, 1e4)
            pairs = trace.captured()
    recs = trace.records()
    trace.clear()
    assert [(n, inner) for n, inner, _, _ in pairs] == [
        ("evaluate", None), ("assemble", None), ("reduced_system", None),
        ("factor_solve", None)]
    engine, = [r for r in recs if r["name"] == "plan.engine"]
    assert {r["id"]: r for r in recs}[engine["parent"]]["name"] == "plan"
    M, P = sc.n_points, sc.n_poses
    Dc = 6 * P + 3 * P
    m = sc.mask > 0
    pairs_ref = len(np.unique(sc.point[m].astype(np.int64) * P
                              + sc.pose_a[m]))
    assert engine["attrs"] == {"Dc": Dc, "M": M, "pairs": pairs_ref,
                               "e_bytes": M * 3 * Dc * 8}


def test_untraced_engine_records_nothing():
    sc, d, ba = _small()
    trace.clear()
    fns = lm.make_solver_fns(ba.problem,
                             SolverOptions(linear_solver="dense_schur"))
    fns["solve_step"](fns["prepare"](ba.params0), 1e4)
    assert trace.records() == [] and trace.captured() == []


@pytest.mark.gpu
def test_captured_dense_schur_solve_leaves_its_device_spans():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    ba = synthetic.CONFIGS["gs_bal"](scale=0.2, seed=1, dtype=torch.float32,
                                     device="cuda")
    opts = SolverOptions(linear_solver="dense_schur")
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]):
        _, s = lm.solve(ba.problem, ba.params0, opts)
        torch.cuda.synchronize()
    recs = trace.records()
    trace.clear()
    lm_device.engines.clear()
    assert s.termination == "CONVERGENCE"
    by_id = {r["id"]: r for r in recs}
    dev = lambda n: [r for r in recs  # noqa: E731
                     if r["device"] and r["name"] == n]
    attempts, prepares = dev("attempt"), dev("prepare")
    assert len(attempts) >= s.num_iterations and prepares
    for name, parent, count in (("reduced_system", "solve_step", attempts),
                                ("factor_solve", "solve_step", attempts),
                                ("evaluate", "prepare", prepares),
                                ("assemble", "prepare", prepares)):
        got = dev(name)
        assert len(got) == len(count), name
        assert all(by_id[r["parent"]]["name"] == parent for r in got)
        assert all(r["seconds"] > 0 for r in got)
    total = lambda n: sum(r["seconds"] for r in dev(n))  # noqa: E731
    assert total("reduced_system") + total("factor_solve") \
        <= total("solve_step")
    assert total("evaluate") + total("assemble") <= total("prepare")


# --- the roofline bound and the readers ------------------------------------

def test_reduced_bound_on_a_problem_counted_by_hand():
    """Point 0 seen by cameras 0 and 1 (n = 18 columns), point 1 twice by
    camera 2 (n = 9); a padded row is left out.  Operations
    18·18 + 3·18·19 + 18·9 + 3·9·10 = 1,782; bytes, float32:
    4 · (3·(18 + 9) + 9·2 + 27²) = 3,312."""
    point = np.array([0, 0, 1, 1, 1])
    pose = np.array([0, 1, 2, 2, 1])
    mask = np.array([1.0, 1.0, 1.0, 1.0, 0.0])
    b = roofline_bal.reduced_bound(point, pose, pose, mask, n_points=2,
                                   n_poses=3, n_intr=3, ni=3, itemsize=4)
    assert b["flops"] == 1782
    assert b["bytes"] == 3312
    assert b["bound_by"] == "bytes"
    assert b["bound_s"] == pytest.approx(3312 / roofline.PEAK_BYTES_S)
    # without an intrinsics tangent: 6 columns a camera
    b = roofline_bal.reduced_bound(point, pose, pose, mask, 2, 3, 3, 0, 4)
    assert b["flops"] == 18 * 12 + 3 * 12 * 13 + 18 * 6 + 3 * 6 * 7


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


def _dense_schur_solve():
    """One solve: three attempts, two of them with a re-prepare."""
    r = _Records()
    solve = r.add("solve", seconds=0.2)
    for i, red in enumerate((0.005, 0.006, 0.004)):
        host = r.add("loop.attempt", solve, 0.03)
        att = r.add("attempt", host, 0.02, device=True)
        step = r.add("solve_step", att, 0.008, device=True)
        r.add("reduced_system", step, red, device=True)
        r.add("factor_solve", step, 0.002, device=True)
        r.add("residual_pass", att, 0.001, device=True)
        if i < 2:
            prep = r.add("prepare", att, 0.009, device=True)
            r.add("evaluate", prep, 0.004 + 0.001 * i, device=True)
            r.add("assemble", prep, 0.003, device=True)
    return r.recs


NEW = ("evaluate_ms_per_prepare", "assemble_ms_per_prepare",
       "factor_solve_ms_per_attempt", "dense_schur_reduced_roofline")


def test_dense_schur_readers(monkeypatch):
    monkeypatch.setattr(trace, "records", _dense_schur_solve)
    run_ = Run(kind="solve_bal")
    assert run.read_metric("evaluate_ms_per_prepare", run_) == \
        pytest.approx(4.5)
    assert run.read_metric("assemble_ms_per_prepare", run_) == \
        pytest.approx(3.0)
    assert run.read_metric("factor_solve_ms_per_attempt", run_) == \
        pytest.approx(2.0)
    assert run.read_metric("reduced_system_ms_per_attempt", run_) == \
        pytest.approx(5.0)
    assert run.read_metric("dense_schur_reduced_roofline", run_) is None
    run_.counters["dense_schur_reduced_bound_s"] = 2e-5
    assert run.read_metric("dense_schur_reduced_roofline", run_) == \
        pytest.approx(100 * 2e-5 / 0.005)


def test_dense_schur_readers_without_records(monkeypatch):
    """No span of the engine (the banded cells, or the parent's program,
    whose dense Schur engine has none) reads as nothing."""
    monkeypatch.setattr(trace, "records", lambda: [])
    run_ = Run(kind="solve_bal",
               counters={"dense_schur_reduced_bound_s": 2e-5})
    for name in NEW:
        assert run.read_metric(name, run_) is None
    import rsba_tpu_torch.utils
    monkeypatch.delattr(rsba_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "rsba_tpu_torch.utils.trace", None)
    for name in NEW:
        assert run.read_metric(name, run_) is None


def test_reference_and_harness_load_no_jax():
    """The new reference imports nothing of the program; the new kind
    and tool load no JAX nor the JAX package."""
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
    ref = loaded("portbench.reference.generator_bal",
                 "portbench.reference.lsq_bal", "portbench.roofline_bal")
    assert not ref & (forbidden | {"rsba_tpu_torch"})
    kind = loaded("portbench.kinds.solve_bal", "portbench.tools.faults_bal",
                  "rsba_tpu_torch.solver.schur")
    assert "portbench" in kind and not kind & forbidden
