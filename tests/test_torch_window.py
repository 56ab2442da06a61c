"""Window plan parity: rsba_tpu_torch.solver.window vs rsba_tpu's.

The plan is built on the host from problems that the two generators make
identically (tests/test_torch_synthetic.py), so every plan array must be
equal, and the plan's index operations must give the reference's results
on the same random data.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsba_tpu.problem import synthetic as jsyn
from rsba_tpu.solver import window as jwin
from rsba_tpu_torch.problem import synthetic as tsyn
from rsba_tpu_torch.solver import window as twin

CASES = [("rs_slerp_robust", 0.01), ("gs_small", 0.05)]


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def pair(request):
    name, scale = request.param
    ja = jsyn.CONFIGS[name](scale=scale, seed=1, dtype=jnp.float64)
    tb = tsyn.CONFIGS[name](scale=scale, seed=1, dtype=torch.float64)
    return ja, tb


def _close(got, want):
    want = np.asarray(want)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    assert got.shape == want.shape
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_window_plan_matches_reference(pair):
    ja, tb = pair
    jp = jwin.build_window_plan(ja.problem)
    tp = twin.build_window_plan(tb.problem)
    for f in ("NR", "G", "L", "W", "n_poses", "n_points"):
        assert getattr(tp, f) == getattr(jp, f), f
    for f in ("row_base", "uv", "t", "mask", "offs_a", "rs_ab", "point_id"):
        _close(getattr(tp, f), np.asarray(getattr(jp, f)).astype(
            np.int64 if f in ("row_base", "offs_a", "point_id")
            else np.float64))


def test_window_plan_ops_match_reference(pair):
    """pose_windows / fold / select / gather / scatter vs the reference
    on the same random data."""
    ja, tb = pair
    jp = jwin.build_window_plan(ja.problem)
    tp = twin.build_window_plan(tb.problem)
    rng = np.random.RandomState(0)
    pose_v = rng.randn(tp.n_poses, 6)
    win_v = rng.randn(tp.NR, tp.W, 5)
    pts_v = rng.randn(tp.n_points, 3)
    T = lambda a: torch.as_tensor(a)  # noqa: E731
    J = jnp.asarray
    _close(tp.pose_windows(T(pose_v)), jp.pose_windows(J(pose_v)))
    _close(tp.fold(T(win_v)), jp.fold(J(win_v)))
    _close(tp.select_a(T(win_v)), jp.select_a(J(win_v)))
    _close(tp.select_b(T(win_v)), jp.select_b(J(win_v)))
    _close(tp.gather_points(T(pts_v)), jp.gather_points(J(pts_v)))
    _close(tp.scatter_points(tp.gather_points(T(pts_v))), pts_v)
    _close(tp.gather_point_scalar(T(pts_v[:, 0])),
           jp.gather_point_scalar(J(pts_v[:, 0])))


def test_plan_rejects_optimizable_intrinsics():
    tb = tsyn.CONFIGS["gs_bal"](scale=0.04, seed=1, dtype=torch.float64)
    assert twin.build_window_plan(tb.problem) is None
