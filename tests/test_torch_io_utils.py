"""BAL I/O, checkpoints and the roofline report of rsba_tpu_torch.

``load_bal`` on the in-repo sample equals the JAX package's arrays
(1e-12) and a file saved by the JAX package's ``save_bal`` loads in the
port to equal arrays; ``save_bal`` round trip, the lossy refusals, PLY
line counts, and a solve of the sample to the JAX package's final cost
(1e-6 relative).  Checkpoints: save / restore / ``restore_history``,
resume continuing the history, the options warning, ``keep``.
``solver_report``: structure, this module's own counts for the banded
engine, None for an engine with no count.
"""
import os
import pathlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsba_tpu.io import bal as jbal
from rsba_tpu.solver import SolverOptions as JOptions
from rsba_tpu.solver import solve as jsolve
from rsba_tpu_torch.geometry import CameraModel
from rsba_tpu_torch.io import bal, export_ply, load_bal, save_bal
from rsba_tpu_torch.problem import synthetic
from rsba_tpu_torch.solver import SolverOptions, Summary, lm, solve
from rsba_tpu_torch.utils import SolverCheckpointer, roofline

torch.set_num_threads(2)
SAMPLE = str(pathlib.Path(__file__).parents[1] / "benchmarks" / "data"
             / "bal_ring12.txt.gz")
OBS = ("uv", "t", "pose_a", "pose_b", "intr_idx", "point", "mask")


def _assert_equal_to_reference(problem, params, jproblem, jparams, tol):
    for f in ("q", "c", "intr", "points"):
        np.testing.assert_allclose(getattr(params, f).numpy(),
                                   np.asarray(getattr(jparams, f)),
                                   rtol=tol, atol=tol)
    for f in OBS:
        np.testing.assert_allclose(getattr(problem.obs, f).numpy(),
                                   np.asarray(getattr(jproblem.obs, f)),
                                   rtol=tol, atol=tol)
    for f in ("pose_free", "point_free", "intr_free", "intr_basis"):
        np.testing.assert_array_equal(getattr(problem, f).numpy(),
                                      np.asarray(getattr(jproblem, f)))
    assert problem.model.projection_sign == jproblem.model.projection_sign
    assert (problem.loss.kind, problem.loss.scale) == (jproblem.loss.kind,
                                                       jproblem.loss.scale)


@pytest.fixture(scope="module")
def sample():
    return (load_bal(SAMPLE, device="cpu"),
            jbal.load_bal(SAMPLE, dtype=jnp.float64))


def test_load_bal_matches_reference(sample):
    (problem, params), (jproblem, jparams) = sample
    assert params.n_poses == 12 and params.n_points == 500
    assert params.dtype == torch.float64
    _assert_equal_to_reference(problem, params, jproblem, jparams, 1e-12)
    # fixed intrinsics, float32, no gauge pin
    p32, x32 = load_bal(SAMPLE, device="cpu", dtype=torch.float32,
                        optimize_intrinsics=False, fix_gauge=False,
                        pad_to=64)
    assert x32.dtype == torch.float32 and p32.intr_tangent_dim == 0
    assert bool(p32.pose_free.all()) and p32.obs.n_obs % 64 == 0


def test_load_bal_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        load_bal(SAMPLE)


def test_file_saved_by_the_reference_loads_equal(sample, tmp_path):
    _, (jproblem, jparams) = sample
    path = str(tmp_path / "from_jax.bal")
    jbal.save_bal(path, jproblem, jparams)
    problem, params = load_bal(path, device="cpu")
    jproblem2, jparams2 = jbal.load_bal(path, dtype=jnp.float64)
    _assert_equal_to_reference(problem, params, jproblem2, jparams2, 1e-12)


@pytest.mark.parametrize("suffix", [".bal", ".bal.gz", ".bal.bz2"])
def test_save_bal_round_trip(sample, tmp_path, suffix):
    (problem, params), _ = sample
    out = str(tmp_path / ("rt" + suffix))
    save_bal(out, problem, params)
    problem2, params2 = load_bal(out, device="cpu")
    np.testing.assert_allclose(params2.points.numpy(), params.points.numpy(),
                               atol=1e-12)
    np.testing.assert_allclose(params2.c.numpy(), params.c.numpy(),
                               atol=1e-9)
    np.testing.assert_allclose(params2.intr.numpy(), params.intr.numpy(),
                               atol=1e-12)
    np.testing.assert_allclose(problem2.obs.uv.numpy(),
                               problem.obs.uv.numpy(), atol=1e-9)
    for f in ("pose_a", "point", "mask"):
        assert torch.equal(getattr(problem2.obs, f), getattr(problem.obs, f))


def test_save_bal_refuses_what_the_format_cannot_hold(sample, tmp_path):
    (problem, params), _ = sample
    out = str(tmp_path / "no.bal")
    with pytest.raises(ValueError, match="BAL camera convention"):
        save_bal(out, problem.replace(model=CameraModel()), params)
    for col, what in ((2, "principal point"), (6, "tangential"),
                      (1, "fx")):
        intr = params.intr.clone()
        intr[0, col] += 1.0
        with pytest.raises(ValueError, match="cannot represent"):
            save_bal(out, problem, params.replace(intr=intr))
    assert not os.path.exists(out)
    with pytest.raises(ValueError, match="header promises"):
        short = tmp_path / "short.bal"
        short.write_text("2 3 4\n0 0 1.0 2.0\n")
        load_bal(str(short), device="cpu")


def test_ply_export_line_counts(tmp_path):
    ba = synthetic.config1_gs_small(scale=0.1, seed=0, device="cpu")
    out = tmp_path / "cloud.ply"
    export_ply(str(out), ba.params0)
    text = out.read_text().splitlines()
    n = ba.params0.n_points + ba.params0.n_poses
    assert text[0] == "ply" and text[2] == f"element vertex {n}"
    assert len(text) == n + text.index("end_header") + 1
    assert text[-1].endswith("255 64 64") and "200 200 200" in text[10]
    assert bal.BAL_CAMERA_MODEL.projection_sign == -1.0


def test_sample_solves_to_the_reference_cost(sample):
    (problem, params0), (jproblem, jparams0) = sample
    kw = dict(linear_solver="dense_schur", max_iterations=40)
    _, sj = jsolve(jproblem, jparams0, JOptions(**kw))
    params, st = solve(problem, params0, SolverOptions(**kw))
    assert st.termination == sj.termination == "CONVERGENCE", st.message
    assert st.initial_cost == pytest.approx(sj.initial_cost, rel=1e-10)
    assert st.final_cost == pytest.approx(sj.final_cost, rel=1e-6)
    assert st.final_rmse_inlier < 0.8
    assert torch.isfinite(params.intr).all()


# --- checkpoints --------------------------------------------------------------

@pytest.mark.parametrize("engine,make", [
    ("dense", lambda: synthetic.config1_gs_small(scale=0.05, device="cpu")),
    ("banded_schur", lambda: synthetic.make_ba_problem(
        n_poses=9, n_points=140, track_len=4, rolling_shutter=True,
        rotation_interp="nlerp", pixel_noise=0.5, seed=17, pad_to=32,
        device="cpu")),
])
def test_checkpoint_restart_resumes_solve(tmp_path, engine, make):
    """The callback gets parameters in the caller's layout (the banded
    engine keeps its own), and a restored state resumes to convergence."""
    ba = make()
    opts = SolverOptions(linear_solver=engine, max_iterations=3)
    ckpt = SolverCheckpointer(str(tmp_path / "ckpt"))
    assert ckpt.restore() is None and ckpt.restore_history() == []
    p1, s1 = lm.solve(ba.problem, ba.params0, opts, callback=ckpt.callback)
    ckpt.wait()
    it0, params_r, radius = ckpt.restore()
    assert it0 == s1.num_iterations and radius > 0
    assert params_r.points.shape == ba.params0.points.shape
    for f in ("q", "c", "intr", "points"):
        assert torch.equal(getattr(params_r, f), getattr(p1, f))
    # the two newest steps are kept, and no temporary file is left
    files = sorted(os.listdir(ckpt.directory))
    assert files == sorted(["history.json"] + [
        f"step_{i}.pt" for i in range(it0 - 1, it0 + 1)]), files

    opts2 = SolverOptions(linear_solver=engine, max_iterations=50,
                          initial_radius=radius)
    _, s2 = lm.solve(ba.problem, params_r, opts2)
    assert s2.termination == "CONVERGENCE", s2.message
    assert s2.final_rmse_inlier <= s1.final_rmse_inlier + 1e-9


def test_checkpoint_history_and_options_continuity(tmp_path):
    ba = synthetic.config1_gs_small(scale=0.05, device="cpu")
    opts = SolverOptions(linear_solver="dense", max_iterations=3)
    ckpt = SolverCheckpointer(str(tmp_path / "ck"), options=opts, keep=1)
    _, s1 = lm.solve(ba.problem, ba.params0, opts, callback=ckpt.callback)
    n1 = s1.num_successful_steps
    assert len([f for f in os.listdir(ckpt.directory)
                if f.endswith(".pt")]) == 1

    opts2 = SolverOptions(linear_solver="dense", max_iterations=50)
    ckpt2 = SolverCheckpointer(str(tmp_path / "ck"), options=opts2)
    it0, params_r, radius = ckpt2.restore()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        history = ckpt2.restore_history()
    assert any("different solver options" in str(x.message) for x in w)
    assert len(history) == n1
    resume = Summary(iterations=list(history))
    resume.initial_cost = history[0].cost
    _, s2 = lm.solve(
        ba.problem, params_r,
        SolverOptions(linear_solver="dense", max_iterations=50,
                      initial_radius=radius),
        callback=ckpt2.callback, summary=resume)
    assert s2.termination == "CONVERGENCE", s2.message
    assert s2.num_iterations > n1
    assert [it.iteration for it in s2.iterations] == list(
        range(s2.num_iterations))
    h2 = SolverCheckpointer(str(tmp_path / "ck")).restore_history()
    assert len(h2) >= s2.num_successful_steps
    # same options: no warning
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        SolverCheckpointer(str(tmp_path / "ck"),
                           options=opts2).restore_history()
    assert not w


# --- roofline -----------------------------------------------------------------

def test_solver_report_structure():
    ba = synthetic.make_ba_problem(
        n_poses=9, n_points=120, track_len=4, rolling_shutter=True,
        rotation_interp="nlerp", pixel_noise=0.5, seed=5, pad_to=32,
        device="cpu")
    opts = SolverOptions(linear_solver="banded_schur")
    fns = lm.make_solver_fns(ba.problem, opts)
    rr = roofline.solver_report(fns, ba.params0, 1e4, repeats=1,
                                options=opts)
    for phase in ("prepare", "solve_step", "iteration"):
        assert rr[phase]["time_s"] > 0
        assert rr[phase]["flops"] > 0 and rr[phase]["bytes"] > 0
        assert rr[phase]["mfu"] >= 0 and rr[phase]["bandwidth_util"] > 0
    for phase in ("prepare", "solve_step"):
        assert rr[phase]["bound"] in ("compute", "memory")
        assert rr[phase]["roofline_util"] > 0
    assert rr["iteration"]["flops"] == (rr["prepare"]["flops"]
                                        + rr["solve_step"]["flops"])
    # the counts are this module's own, from the shapes
    plan = fns["raw"]["bound"][0]
    n_valid = int(ba.problem.obs.mask.sum())
    assert rr["prepare"]["flops"] == n_valid * roofline.slot_flops(
        ba.problem.model, ba.problem.loss)
    c = roofline.solve_step_counts(plan.NR, plan.W, plan.G, plan.n_poses, 8,
                                   opts.max_cg_iterations)
    assert rr["solve_step"]["flops"] == c["flops"] == (
        c["bmm_flops"] + 100 * c["band_product_flops"])
    assert c["bmm_flops"] == 2 * plan.NR * (6 * plan.W) ** 2 * 3 * plan.G


def test_report_has_no_count_for_the_flat_engines(monkeypatch):
    ba = synthetic.config1_gs_small(scale=0.05, device="cpu")
    fns = lm.make_solver_fns(ba.problem, SolverOptions(linear_solver="dense"))
    rr = roofline.solver_report(fns, ba.params0, 1e4, repeats=1)
    for phase in ("prepare", "solve_step", "iteration"):
        assert rr[phase]["time_s"] > 0
        assert rr[phase]["flops"] is None and rr[phase]["bytes"] is None
        assert "mfu" not in rr[phase]
    rec = roofline.phase_report(lambda x: torch.sum(x * x),
                                (torch.ones(64),), repeats=1)
    assert rec["time_s"] > 0 and rec["flops"] is None
    # the published peaks of one H100, and their override
    assert roofline.peaks() == (67e12, 3.35e12)
    monkeypatch.setenv("RSBA_PEAK_FLOPS", "1e12")
    monkeypatch.setenv("RSBA_PEAK_BYTES_S", "2e11")
    assert roofline.peaks() == (1e12, 2e11)
    rec = roofline.phase_report(lambda x: torch.sum(x * x),
                                (torch.ones(64),), repeats=1,
                                counts={"flops": 128.0, "bytes": 260.0})
    assert rec["bound"] == "memory" and rec["arithmetic_intensity"] < 1
    assert rec["roofline_util"] == rec["bandwidth_util"]
