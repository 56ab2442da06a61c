"""The incremental video-SfM session of rsba_tpu_torch.

(a) Parity: one small rolling-shutter sequence (7 frames, 150 points,
nlerp, seed fixed; the JAX session compiles anew for every solve, about
12 s a frame, so two registrations follow the one windowed BA) is fed frame by frame, as the same numpy arrays, to
``rsba_tpu.pipeline.SfmSession`` and to the port's, both in float64 on
the CPU: the same event per frame, the same set of triangulated track
ids, poses within 1e-5 up to quaternion sign, and the final full BA's
inlier RMSE within 1e-5 px.

(b) The port alone, with the assertions of ``tests/test_pipeline.py``:
the 13-pose rolling-shutter sequence reconstructed from scratch to the
noise floor, the bootstrap deferred without parallax, and float32 with
``shape_buckets=True`` (dummy poses and points that no observation
touches) at that file's float32 envelope.
"""
import numpy as np
import pytest
import torch

from rsba_tpu.pipeline import SfmSession as JSession
from rsba_tpu.problem import synthetic as jsyn
from rsba_tpu_torch import SfmSession
from rsba_tpu_torch.geometry import CameraModel
from rsba_tpu_torch.geometry import quaternion as quat
from rsba_tpu_torch.problem import synthetic

torch.set_num_threads(2)


def _frames(ba):
    """Per-frame (track ids, pixels) of a synthetic problem, as numpy."""
    obs = ba.problem.obs
    m = np.asarray(obs.mask) > 0
    pa = np.asarray(obs.pose_a)[m]
    pid = np.asarray(obs.point)[m]
    uv = np.asarray(obs.uv)[m]
    return [(pid[pa == f], uv[pa == f]) for f in range(int(pa.max()) + 1)]


def _model(m):
    return CameraModel(rolling_shutter=m.rolling_shutter,
                       rotation_interp=m.rotation_interp,
                       use_distortion=m.use_distortion,
                       projection_sign=m.projection_sign)


@pytest.fixture(scope="module")
def pair():
    """Both sessions after the same seven frames and a full BA each."""
    ba = jsyn.make_ba_problem(
        n_poses=8, n_points=150, track_len=6, rolling_shutter=True,
        rotation_interp="nlerp", use_distortion=False, pixel_noise=0.5,
        seed=4, name="session_parity")
    intr = np.asarray(ba.params_gt.intr[0])
    kw = dict(window=4, ba_interval=4)
    js = JSession(intr, ba.problem.model, ba.image_size, **kw)
    ts = SfmSession(intr, _model(ba.problem.model), ba.image_size,
                    device="cpu", **kw)
    for pid, uv in _frames(ba):
        js.add_frame(pid, uv, rows=uv[:, 1])
        ts.add_frame(pid, uv, rows=uv[:, 1])
    return ba, js, ts, js.bundle_adjust(window=None), \
        ts.bundle_adjust(window=None)


def test_session_events_match_reference(pair):
    _, js, ts, _, _ = pair
    assert len(ts.log) == len(js.log) == 7
    for a, b in zip(ts.log, js.log):
        assert a["event"] == b["event"], (a, b)
        assert a.get("method") == b.get("method")
        assert a.get("matches") == b.get("matches")
        assert a.get("new_points") == b.get("new_points")
    assert ts.bootstrapped and all(ts.registered)
    assert ts.registered == js.registered
    assert ts.n_registered_by == {"pnp_prior": 5, "ransac": 0}
    assert [r["event"] for r in ts.log] == ["anchor", "bootstrap"] \
        + ["register"] * 5


def test_session_map_matches_reference(pair):
    _, js, ts, _, _ = pair
    assert set(ts.points) == set(js.points) and len(ts.points) > 60
    qt, ct, pts_t = ts.reconstruction()
    qj, cj, pts_j = js.reconstruction()
    sign = np.sign(np.sum(qt * qj, axis=1, keepdims=True))
    np.testing.assert_allclose(sign * qt, qj, atol=1e-5)
    np.testing.assert_allclose(ct, cj, atol=1e-5)
    ids = sorted(pts_t)
    np.testing.assert_allclose(np.stack([pts_t[i] for i in ids]),
                               np.stack([pts_j[i] for i in ids]), atol=1e-4)
    np.testing.assert_allclose(ts.q_virtual * np.sign(
        np.sum(ts.q_virtual * js.q_virtual)), js.q_virtual, atol=1e-5)


def test_session_final_ba_matches_reference(pair):
    ba, js, ts, sj, st = pair
    assert st.termination == sj.termination == "CONVERGENCE"
    assert st.final_rmse_inlier == pytest.approx(sj.final_rmse_inlier,
                                                 abs=1e-5)
    assert st.final_rmse_inlier < 2.5 * ba.pixel_noise
    assert (st.linear_solver, st.evaluator) == ("banded_schur",
                                                "torch+device_loop")
    # every BA of the session went through the banded engine
    assert [b["engine"] for b in ts.ba_log] == \
        ["banded_schur/torch+device_loop"] * len(ts.ba_log)
    assert [b["window"] for b in ts.ba_log] == [None, 4, None]
    assert [b["frames"] for b in ts.ba_log] == [2, 5, 7]


def test_session_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        SfmSession(np.ones(9), CameraModel(), (640, 480))


def _relative_angles(q):
    q = torch.as_tensor(np.asarray(q), dtype=torch.float64)
    return torch.linalg.vector_norm(
        quat.to_axis_angle(quat.relative(q[:-1], q[1:])), dim=-1).numpy()


def test_session_reconstructs_rs_sequence_from_scratch():
    ba = synthetic.make_ba_problem(
        n_poses=13, n_points=300, track_len=6, rolling_shutter=True,
        rotation_interp="nlerp", use_distortion=False, pixel_noise=0.5,
        seed=4, name="session_rs", device="cpu")
    intr = ba.params_gt.intr[0].numpy()
    sess = SfmSession(intr, ba.problem.model, ba.image_size,
                      window=6, ba_interval=4, device="cpu")
    for pid, uv in _frames(ba):
        report = sess.add_frame(pid, uv, rows=uv[:, 1])
        assert set(report["wall_s"]) <= {"bootstrap", "register",
                                         "triangulate", "ba"}
    assert sess.bootstrapped
    assert all(sess.registered)
    s = sess.bundle_adjust(window=None)
    assert s.termination == "CONVERGENCE", s.message
    # The shutter times come from measured (noisy) rows, not from the
    # generator's fixed-point rows: a wider envelope than the solver tests.
    assert s.final_rmse_inlier < 2.5 * ba.pixel_noise, s.final_rmse_inlier
    q_est, _, pts = sess.reconstruction()
    assert q_est.shape == (12, 4) and len(pts) >= 0.6 * 300
    np.testing.assert_allclose(_relative_angles(q_est),
                               _relative_angles(ba.params_gt.q[:12]),
                               atol=3e-3)


def test_session_falls_to_ransac_after_a_failed_prior(monkeypatch):
    """A registration whose prior-seeded solve ends far from the matches
    goes through P3P-RANSAC, as the reference's does, and the session
    carries on from that pose."""
    from rsba_tpu_torch.pipeline import session as session_mod
    ba = synthetic.make_ba_problem(
        n_poses=8, n_points=150, track_len=6, rolling_shutter=True,
        rotation_interp="nlerp", use_distortion=False, pixel_noise=0.5,
        seed=4, name="session_ransac", device="cpu")
    real = session_mod.register_frame
    calls = []

    def failing_once(*args, **kw):
        out = real(*args, **kw)
        calls.append(out[4].final_rmse_inlier)
        if len(calls) == 2:             # frame 3's prior-seeded solve
            out[4].final_rmse_inlier = 1e3
        return out

    monkeypatch.setattr(session_mod, "register_frame", failing_once)
    sess = SfmSession(ba.params_gt.intr[0].numpy(), ba.problem.model,
                      ba.image_size, window=4, ba_interval=4, device="cpu")
    for pid, uv in _frames(ba):
        sess.add_frame(pid, uv, rows=uv[:, 1])
    assert all(sess.registered)
    assert sess.n_registered_by == {"pnp_prior": 4, "ransac": 1}
    assert [r.get("method") for r in sess.log[2:]] == \
        ["pnp_prior", "ransac", "pnp_prior", "pnp_prior", "pnp_prior"]
    s = sess.bundle_adjust(window=None)
    assert s.termination == "CONVERGENCE", s.message
    assert s.final_rmse_inlier < 2.5 * ba.pixel_noise


def test_session_defers_bootstrap_without_parallax():
    # Two identical frames: no baseline, the two-view init must not fire.
    rng = np.random.RandomState(0)
    pid = np.arange(50)
    uv = rng.uniform(100, 500, (50, 2))
    intr = np.array([800.0, 800, 320, 240, 0, 0, 0, 0, 0])
    sess = SfmSession(intr, CameraModel(), (640, 480), device="cpu")
    sess.add_frame(pid, uv)
    r = sess.add_frame(pid, uv + rng.randn(50, 2) * 0.05)
    assert not sess.bootstrapped
    assert r["event"] == "bootstrap_deferred"
    # too few common tracks defers as well
    r = sess.add_frame(np.arange(100, 110), uv[:10])
    assert r == {"frame": 2, "event": "bootstrap_deferred", "common": 0,
                 "wall_s": r["wall_s"]}
    assert sess.registered == [True, False, False]


def test_session_f32_mode_with_shape_buckets():
    """float32, the card's dtype, with bucketed shapes: every BA problem
    carries dummy poses and points that no observation touches, and
    frames outside the window are constant."""
    ba = synthetic.make_ba_problem(
        n_poses=14, n_points=300, track_len=6, rolling_shutter=False,
        use_distortion=False, pixel_noise=0.5, seed=6, name="session_f32",
        device="cpu")
    intr = ba.params_gt.intr[0].numpy()
    sess = SfmSession(intr, ba.problem.model, ba.image_size,
                      window=6, ba_interval=4, dtype=torch.float32,
                      shape_buckets=True, device="cpu")
    for pid, uv in _frames(ba):
        sess.add_frame(pid, uv)
    assert sess.bootstrapped
    assert all(sess.registered), [r for r in sess.log
                                  if not r.get("registered", True)]
    problem, params0, index = sess._build_problem(window=6)
    assert params0.dtype == torch.float32
    assert params0.n_poses == 16 and params0.n_points % 256 == 0
    assert problem.obs.n_obs % 2048 == 0
    assert not problem.pose_free[:8].any() and problem.pose_free[8:14].all()
    assert not problem.pose_free[14:].any()
    assert not problem.point_free[len(index["tids"]):].any()
    s = sess.bundle_adjust(window=None)
    assert s.linear_solver == "banded_schur"
    assert s.final_rmse_inlier < 2.0 * ba.pixel_noise, s.final_rmse_inlier
    q_est, _, _ = sess.reconstruction()
    np.testing.assert_allclose(_relative_angles(q_est),
                               _relative_angles(ba.params_gt.q), atol=3e-3)
