"""Config 5 (``rs_mhost_pcg``) and its benchmark cell, on the CPU at 21
poses and 2,000 points (``config5_rs_large(scale=0.002)``).

The benchmark's frozen generator against the program's preset; the block
band reference (``portbench/reference/lsq_band.py``) against the dense
one (``lsq.py``) at seeded perturbed parameters: equal cost, Gauss-Newton
gain and step to 1e-10; the program's float64 solve at a stationary point
of the band reference; whole runs of the ``rs_mhost_pcg.cold`` cell, sound
and as its bfloat16 control; and the cell's two band PCG readers on
synthetic records.  The file imports neither jax nor rsba_tpu (from the
repo root):

    python -m pytest --noconftest -o addopts= tests/test_torch_rs_mhost.py
"""
import numpy as np
import pytest
import torch

from portbench import manifest, roofline_band_pcg, run, spans
from portbench.kinds import solve
from portbench.record import Run
from portbench.reference import generator, lsq, lsq_band
from rsba_tpu_torch.problem import synthetic
from rsba_tpu_torch.solver import SolverOptions, lm
from rsba_tpu_torch.utils import roofline

torch.set_num_threads(2)
BENCH = manifest.load()
SEED = 2**31 + 71
SCALE = 0.002


def _generator() -> dict:
    p = dict(manifest.config(BENCH, "rs_mhost_pcg")["generator"])
    p.update(n_poses=int(10000 * SCALE) + 1, n_points=int(1000000 * SCALE))
    return p


@pytest.fixture(scope="module")
def small():
    """(scene, reference data, the program's problem) at one seed."""
    sc = generator.make_scene(_generator(), 3)
    ba = synthetic.config5_rs_large(scale=SCALE, seed=3, dtype=torch.float64,
                                    device="cpu")
    return sc, lsq.Data.of(sc, "cpu"), ba


def test_generator_reproduces_program_preset(small):
    sc, _, ba = small
    o = ba.problem.obs
    assert (sc.n_poses, sc.n_points) == (21, 2000) and sc.n_valid > 10000
    np.testing.assert_allclose(sc.uv, o.uv.numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(sc.t, o.t.numpy(), rtol=0, atol=1e-12)
    for f in ("pose_a", "pose_b", "point", "mask"):
        np.testing.assert_array_equal(getattr(sc, f), getattr(o, f).numpy())
    for f in ("q", "c", "points"):
        np.testing.assert_allclose(sc.start[f], getattr(ba.params0,
                                                        f).numpy(),
                                   rtol=0, atol=1e-12)


def _perturbed(sc, seed: int) -> dict:
    """The scene's truth moved by seeded noise of the start's size."""
    rng = np.random.default_rng(seed)
    dc = rng.standard_normal((sc.n_poses, 6)) * ([2e-3] * 3 + [5e-3] * 3)
    dx = rng.standard_normal((sc.n_points, 3)) * 5e-3
    return lsq._apply(lsq.params_on(sc.gt, "cpu"), torch.from_numpy(dc),
                      torch.from_numpy(dx))


@pytest.mark.parametrize("at", ["start", "seed11"])
def test_band_reference_equals_dense_reference(small, at):
    """Cost, Gauss-Newton gain (λ = 1e-9) and step (λ = 1e-5 and 1e-3)
    equal ``lsq.py``'s to 1e-10 relative: the same sums, factored by
    blocks of the band in place of one dense Cholesky (readings: gain
    3.5e-12, steps 2.5e-12 and 3.1e-13).  One fixed pose leaves the scale
    free, so the step at λ = 1e-9 is set only to the system's
    conditioning: there the two factorisations' steps differ by 8.7e-6
    while their gains agree."""
    sc, d, _ = small
    p = (lsq.params_on(sc.start, "cpu") if at == "start"
         else _perturbed(sc, 11))
    assert lsq_band.cost_stats(d, p) == lsq.cost_stats(d, p)
    dense, band = lsq.gauss_newton_gain(d, p), lsq_band.gauss_newton_gain(d, p)
    assert band["lambda"] == dense["lambda"]
    assert band["gain"] == pytest.approx(dense["gain"], rel=1e-10)
    blocks = lsq._point_blocks(d)
    h = lsq_band.half_width(d, blocks)
    assert h == 8                       # tracks of 8 frames, pose_b = a + 1
    ne, ne_band = lsq._normal_equations(d, p), \
        lsq_band._normal_equations(d, p, h)
    for lam in (1e-5, 1e-3):
        want = lsq._step(d, ne, blocks, lam)
        got = lsq_band._step(d, ne_band, blocks, lam, h)
        for g, w in zip(got, want):
            assert float((g - w).abs().max()) <= 1e-10 * float(w.abs().max())


def test_band_cholesky_refuses_an_indefinite_band():
    band = torch.zeros((7, 3, 6, 6), dtype=torch.float64)
    band[:, 0] = torch.eye(6, dtype=torch.float64)
    band[4, 0, 2, 2] = -1.0
    assert lsq_band._band_cholesky(band, 5, 2) is None
    band[4, 0, 2, 2] = 1.0
    Ld, Ls = lsq_band._band_cholesky(band, 5, 2)
    x = lsq_band._band_solve((Ld, Ls), torch.arange(30.0,
                                                    dtype=torch.float64))
    assert torch.equal(x, torch.arange(30.0, dtype=torch.float64))


def test_float64_solve_reaches_a_stationary_point_of_the_band_reference(
        small):
    sc, d, ba = small
    x, s = lm.solve(ba.problem, ba.params0, SolverOptions())
    assert s.termination == "CONVERGENCE" and s.evaluator == \
        "torch+device_loop"
    p = lsq_band.params_on({f: getattr(x, f) for f in ("q", "c", "points")},
                           "cpu")
    cost = lsq_band.cost_stats(d, p)
    assert s.final_cost == pytest.approx(cost["cost"], rel=1e-12)
    assert lsq_band.gauss_newton_gain(d, p)["gain"] < 1e-8 * cost["cost"]
    start = lsq_band.params_on(sc.start, "cpu")
    assert lsq_band.gauss_newton_gain(d, start)["gain"] > cost["cost"]


# --- whole runs of the cell -----------------------------------------------

def _cell_run(control="none"):
    cfg = manifest.config(BENCH, "rs_mhost_pcg")
    cfg["generator"] = _generator()
    return run.execute("rs_mhost_pcg.cold", SEED, 0.5, False, device="cpu",
                       cfg=cfg, control=control)


def test_sound_run_is_correct():
    out = _cell_run()
    assert out["correct"], out["check"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"solve_s", "setup_s"}


def test_control_in_bfloat16_is_not_correct():
    out = _cell_run(control="bf16")
    assert not out["correct"]
    for n in ("gn_gain", "cost_gap", "rmse_gap"):
        assert out["check"][n]["value"] > out["check"][n]["limit"], n
    assert solve.lsq is lsq         # the binding ends with the run


# --- the readers -----------------------------------------------------------

def test_bound_is_the_programs_bound():
    for P, W, itemsize in ((10001, 9, 4), (1001, 11, 4), (201, 13, 8)):
        want = roofline.band_pcg_bound(P, W, itemsize, 37)
        assert roofline_band_pcg.bytes_per_pass(P, W, itemsize) \
            == want["bytes_per_pass"]
        assert 1e3 * roofline_band_pcg.bound_s(P, W, itemsize, 37) \
            == pytest.approx(want["bound_ms"], rel=1e-12)


def _records(shapes):
    """Two profiled solves of one attempt each, their device spans, and
    one ``band_pcg.plan`` per solve, of ``shapes[k]`` in solve k."""
    recs, rid = [], iter(range(1, 100))

    def add(name, parent=None, seconds=0.0, device=False, **attrs):
        i = next(rid)
        recs.append({"name": name, "id": i,
                     "parent": None if parent is None else parent["id"],
                     "request": i if parent is None else parent["request"],
                     "start_ns": 0, "end_ns": 0,
                     "seconds": seconds, "device": device, "attrs": attrs})
        return recs[-1]
    for (P, W, itemsize), seconds in zip(shapes, (0.004, 0.006)):
        add("plan", seconds=0.1)
        solve = add("solve", seconds=1.0)
        add("band_pcg.plan", solve, 1e-4, P=P, W=W, itemsize=itemsize,
            ctas=16, poses_per_cta=626, rows_in_smem=False,
            smem_bytes=118872)
        att = add("attempt", solve, 0.03, device=True)
        step = add("solve_step", att, 0.02, device=True)
        pcg = add("pcg", step, 0.0075, device=True)
        add("band_pcg", pcg, seconds, device=True)
    return recs


def test_band_pcg_readers(monkeypatch):
    """The bound counts each profiled solve's own passes at its own band's
    shape: a traced run's later records also read ``traced``, and two
    solves of one slice may hold bands of two shapes."""
    r = Run(kind="solve")
    r.trace = {"busy_s": 1.0, "window_s": 2.0, "ops": {}}
    r.solves = [{"traced": True, "cg_iters": 150},
                {"traced": True, "cg_iters": 50},
                {"traced": True, "cg_iters": 1000}]
    monkeypatch.setattr(spans, "records",
                        lambda: _records([(10001, 9, 4), (10001, 9, 4)]))
    assert run.read_metric("band_pcg_ms_per_attempt", r) \
        == pytest.approx(5.0)
    bound = 200 * 4 * 10001 * (36 * 17 + 36 + 24) / 3.35e12
    assert run.read_metric("band_pcg_roofline", r) \
        == pytest.approx(100 * bound / 0.010)
    monkeypatch.setattr(spans, "records",
                        lambda: _records([(10001, 9, 4), (1001, 11, 8)]))
    bound = (150 * 4 * 10001 * (36 * 17 + 36 + 24)
             + 50 * 8 * 1001 * (36 * 21 + 36 + 24)) / 3.35e12
    assert run.read_metric("band_pcg_roofline", r) \
        == pytest.approx(100 * bound / 0.010)
    # a solve without its plan span adds neither bound nor time
    monkeypatch.setattr(spans, "records", lambda: [
        x for x in _records([(10001, 9, 4), (1001, 11, 8)])
        if not (x["name"] == "band_pcg.plan" and x["attrs"]["P"] == 1001)])
    assert run.read_metric("band_pcg_roofline", r) \
        == pytest.approx(100 * 150 * 4 * 10001 * (36 * 17 + 36 + 24)
                         / 3.35e12 / 0.004)
    # a program without these spans: nothing to report
    monkeypatch.setattr(spans, "records", lambda: [])
    assert run.read_metric("band_pcg_roofline", r) is None
    assert run.read_metric("band_pcg_ms_per_attempt", r) is None
