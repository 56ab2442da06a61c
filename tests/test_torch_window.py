"""Window plan parity: rsba_tpu_torch.solver.window vs rsba_tpu's.

The port builds its plan with torch ops on the problem's device (here the
CPU), the reference with NumPy on the host, from problems that the two
generators make identically (tests/test_torch_synthetic.py) or from the
reference's problem carried over, so every plan array must be equal, and
the plan's index operations must give the reference's results on the
same random data.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsba_tpu.problem import synthetic as jsyn
from rsba_tpu.solver import window as jwin
from rsba_tpu_torch.problem import synthetic as tsyn
from rsba_tpu_torch.problem import types as ttypes
from rsba_tpu_torch.solver import window as twin

CASES = [("rs_slerp_robust", 0.01), ("gs_small", 0.05)]


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def pair(request):
    name, scale = request.param
    ja = jsyn.CONFIGS[name](scale=scale, seed=1, dtype=jnp.float64)
    tb = tsyn.CONFIGS[name](scale=scale, seed=1, dtype=torch.float64,
                            device="cpu")
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


def _generated(name, scale):
    """Config ``name`` at ``scale`` from each package's generator: the
    reference's problem and the port's."""
    return (jsyn.CONFIGS[name](scale=scale, seed=1,
                               dtype=jnp.float64).problem,
            tsyn.CONFIGS[name](scale=scale, seed=1, dtype=torch.float64,
                               device="cpu").problem)


def _edited(name, scale, edit):
    """The reference's problem of config ``name`` at ``scale`` with its
    observation arrays changed by ``edit(obs arrays as numpy) -> dict of
    changes``, and that problem carried over to the port."""
    ja = jsyn.CONFIGS[name](scale=scale, seed=1, dtype=jnp.float64)
    obs = ja.problem.obs
    arrays = {f: np.array(getattr(obs, f))
              for f in ("pose_a", "pose_b", "point", "mask")}
    changes = {k: jnp.asarray(v) for k, v in edit(arrays).items()}
    jprob = ja.problem.replace(obs=obs.replace(**changes))
    return jprob, ttypes.problem_from_numpy(jprob, device="cpu")


def _skewed(a):
    """A third of the points lose their observations (window base 0) and
    a sixth move their tracks to start at pose 20: two bases each far
    denser than the rest, split across rows, whose poses outgrow the
    first fold table."""
    point, valid = a["point"], a["mask"] > 0
    m = point.max() + 1
    lo = np.full(m, np.iinfo(np.int32).max)
    np.minimum.at(lo, point[valid], a["pose_a"][valid])
    moved = (point >= m // 3) & (point < m // 2)
    shift = np.where(moved, 20 - lo[point], 0)
    return {"mask": np.where(point < m // 3, 0.0, a["mask"]),
            "pose_a": a["pose_a"] + shift, "pose_b": a["pose_b"] + shift}


def _wide_track(a):
    """The last observation of a point first seen at pose 0 moved to pose
    30: a track 31 poses wide."""
    valid = (a["mask"] > 0)
    p = a["point"][np.nonzero(valid & (a["pose_a"] == 0))[0][0]]
    j = np.nonzero(valid & (a["point"] == p))[0][-1]
    shift = np.where(np.arange(valid.size) == j,
                     30 - a["pose_a"][j], 0)
    return {"pose_a": a["pose_a"] + shift, "pose_b": a["pose_b"] + shift}


def _pose_gap(a):
    """One valid observation with pose_b = pose_a + 2."""
    i = np.nonzero((a["mask"] > 0) & (a["pose_a"] + 2 < a["pose_a"].max())
                   )[0][0]
    pb = a["pose_b"].copy()
    pb[i] = a["pose_a"][i] + 2
    return {"pose_b": pb}


#: (id, the two problems, build_window_plan's arguments, whether the plan
#: is None)
PLAN_CASES = [
    ("rs_slerp_robust", lambda: _generated("rs_slerp_robust", 0.01), {},
     False),
    ("gs_small", lambda: _generated("gs_small", 0.05), {}, False),
    ("skewed", lambda: _edited("rs_slerp_robust", 0.05, _skewed), {},
     False),
    ("nr_multiple16", lambda: _generated("rs_slerp_robust", 0.02),
     {"nr_multiple": 16}, False),                         # NR 24 → 32
    ("wide_track", lambda: _edited("rs_slerp_robust", 0.05, _wide_track),
     {}, True),
    ("pose_gap", lambda: _edited("rs_slerp_robust", 0.05, _pose_gap), {},
     True),
]


@pytest.mark.parametrize("case", PLAN_CASES, ids=[c[0] for c in PLAN_CASES])
def test_window_plan_matches_reference(case):
    """Every plan array equals the reference's, and the two fold tables
    fold as the reference's one-hot fold does; a problem outside the
    layout gives None in both."""
    name, make, kw, none = case
    jprob, tprob = make()
    jp = jwin.build_window_plan(jprob, **kw)
    tp = twin.build_window_plan(tprob, **kw)
    if none:
        assert jp is None and tp is None
        return
    for f in ("NR", "G", "L", "W", "n_poses", "n_points"):
        assert getattr(tp, f) == getattr(jp, f), f
    for f in ("row_base", "uv", "t", "mask", "offs_a", "rs_ab", "point_id"):
        _close(getattr(tp, f), np.asarray(getattr(jp, f)).astype(
            np.int64 if f in ("row_base", "offs_a", "point_id")
            else np.float64))
    assert tp.NR % kw.get("nr_multiple", 8) == 0
    win_v = np.random.RandomState(0).randn(tp.NR, tp.W, 5)
    _close(tp.fold(torch.as_tensor(win_v)), jp.fold(jnp.asarray(win_v)))
    if name == "skewed":
        rows_per_base = np.bincount(tp.row_base[tp.point_id[:, 0]
                                                < tp.n_points].numpy())
        assert (rows_per_base > 1).sum() >= 2
        assert tp.heavy_pose.numel() > 0


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
    tb = tsyn.CONFIGS["gs_bal"](scale=0.04, seed=1, dtype=torch.float64,
                                device="cpu")
    assert twin.build_window_plan(tb.problem) is None
