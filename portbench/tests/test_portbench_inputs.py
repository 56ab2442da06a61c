"""The benchmark's frozen generator and float64 reference against the
program, on the CPU at small sizes."""
import numpy as np
import pytest
import torch

from portbench import manifest
from portbench.reference import generator, lsq
from rsba_tpu_torch.geometry import Loss
from rsba_tpu_torch.problem import synthetic
from rsba_tpu_torch.solver import lm, residuals
from rsba_tpu_torch.solver.options import SolverOptions

torch.set_num_threads(2)


def _config_generator(name: str, scale: float) -> dict:
    """A configuration's generator group at ``scale``, sized as the
    program's presets size theirs."""
    p = dict(manifest.config(manifest.load(), name)["generator"])
    frames = p["n_poses"] - 1
    p["n_poses"] = max(int(frames * scale), 4) + 1
    p["n_points"] = max(int(p["n_points"] * scale), 100)
    return p


@pytest.mark.parametrize("name", ["rs_slerp_robust", "rs_video_linear"])
@pytest.mark.parametrize("seed", [0, 2**32 - 5])
def test_generator_reproduces_program_presets(name, seed):
    scale = 0.03
    sc = generator.make_scene(_config_generator(name, scale), seed)
    ba = synthetic.CONFIGS[name](scale=scale, seed=seed,
                                 dtype=torch.float64, device="cpu")
    o = ba.problem.obs
    assert sc.n_valid > 1000
    np.testing.assert_allclose(sc.uv, o.uv.numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(sc.t, o.t.numpy(), rtol=0, atol=1e-12)
    for f in ("pose_a", "pose_b", "point", "mask"):
        np.testing.assert_array_equal(getattr(sc, f), getattr(o, f).numpy())
    np.testing.assert_array_equal(sc.pose_free, ba.problem.pose_free.numpy())
    np.testing.assert_allclose(sc.intr, ba.params_gt.intr.numpy(), atol=0)
    for key, src in (("gt", ba.params_gt), ("start", ba.params0)):
        for f in ("q", "c", "points"):
            np.testing.assert_allclose(getattr(sc, key)[f],
                                       getattr(src, f).numpy(),
                                       rtol=0, atol=1e-12)


def _flagship():
    """The program's tiny flagship problem (config 4's model at 9 poses,
    160 points, tracks of 4) and the same from the frozen generator."""
    p = {"n_poses": 9, "n_points": 160, "track_len": 4,
         "rolling_shutter": True, "interp": "slerp", "distortion": True,
         "loss": {"kind": "huber", "scale": 4.0}, "pixel_noise": 0.4,
         "rot_sigma": 0.01, "trans_sigma": 0.02, "point_sigma": 0.02,
         "pad_to": 64}
    ba = synthetic.make_ba_problem(
        n_poses=9, n_points=160, track_len=4, rolling_shutter=True,
        rotation_interp="slerp", use_distortion=True,
        loss=Loss("huber", 4.0), pixel_noise=0.4, seed=0,
        dtype=torch.float64, device="cpu", pad_to=64)
    return generator.make_scene(p, 0), ba


def test_reference_matches_program_evaluator():
    sc, ba = _flagship()
    d = lsq.Data.of(sc, "cpu")
    for params in (ba.params0, ba.params_gt):
        p = lsq.params_on({f: getattr(params, f).numpy()
                           for f in ("q", "c", "points")}, "cpu")
        r_ref = lsq.residuals(d, p)
        r_prog = residuals.residuals_raw(params, ba.problem)[
            ba.problem.obs.mask > 0]
        np.testing.assert_allclose(r_ref.numpy(), r_prog.numpy(),
                                   rtol=1e-10, atol=1e-9)
        got = lsq.cost_stats(d, p)
        want = float(residuals.cost_only(params, ba.problem))
        assert abs(got["cost"] - want) <= 1e-10 * want
        sq, n, sq_in, n_in = residuals.error_stats(params, ba.problem, 12.0)
        assert got["rmse_inlier"] == pytest.approx(
            float(np.sqrt(float(sq_in) / float(n_in))), rel=1e-10)


def test_reference_optimum_matches_program_float64_solve():
    """The reference's optimum and the program's float64 LM solve agree
    on a problem of config 4's model with tracks of 10."""
    p = _config_generator("rs_slerp_robust", 0.02)
    p["n_points"] = 1000
    sc = generator.make_scene(p, 7)
    d = lsq.Data.of(sc, "cpu")
    _, best = lsq.optimum(d, lsq.params_on(sc.gt, "cpu"))
    ba = synthetic.make_ba_problem(
        n_poses=p["n_poses"], n_points=1000, track_len=10,
        rolling_shutter=True, rotation_interp="slerp", use_distortion=True,
        loss=Loss("huber", 4.0), outlier_fraction=0.05, pixel_noise=0.5,
        seed=7, dtype=torch.float64, device="cpu", rot_sigma=0.005,
        trans_sigma=0.01, point_sigma=0.01)
    x, s = lm.solve(ba.problem, ba.params0,
                    SolverOptions(function_tolerance=1e-12,
                                  gradient_tolerance=1e-14,
                                  parameter_tolerance=1e-14))
    assert s.termination == "CONVERGENCE"
    assert best["steps"] <= 15
    assert abs(s.final_cost - best["cost"]) <= 1e-9 * best["cost"]
    assert s.final_rmse_inlier == pytest.approx(best["rmse_inlier"],
                                                rel=1e-6)
    # One reference Gauss-Newton step from the program's solution gains
    # nothing; from the start, or with one point moved, it gains much.
    p = lsq.params_on({f: getattr(x, f).numpy()
                       for f in ("q", "c", "points")}, "cpu")
    assert lsq.gauss_newton_gain(d, p)["gain"] <= 1e-10 * best["cost"]
    assert lsq.gauss_newton_gain(
        d, lsq.params_on(sc.start, "cpu"))["gain"] >= 1e-2 * best["cost"]
    p["points"][5] += 0.05
    assert lsq.gauss_newton_gain(d, p)["gain"] >= 1e-4 * best["cost"]


def test_frames_of_groups_the_valid_observations_by_frame():
    p = _config_generator("rs_video_linear", 0.05)
    sc = generator.make_scene(p, 3)
    frames = generator.frames_of(sc)
    assert len(frames) == sc.n_poses - 1
    assert sum(len(pid) for pid, _ in frames) == sc.n_valid
    m = sc.mask > 0
    for f in (0, len(frames) // 2, len(frames) - 1):
        pid, uv = frames[f]
        sel = m & (sc.pose_a == f)
        np.testing.assert_array_equal(pid, sc.point[sel])
        np.testing.assert_array_equal(uv, sc.uv[sel])
