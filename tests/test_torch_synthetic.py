"""Synthetic generator parity: rsba_tpu_torch vs rsba_tpu.

Both generators draw from ``np.random.RandomState(seed)`` in the same
order and project with the same math, so at float64 the problems agree:
integer arrays exactly, floats to 1e-12.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsba_tpu.problem import synthetic as jsyn
from rsba_tpu_torch.problem import synthetic as tsyn
from rsba_tpu_torch.problem import types as ttypes

CASES = [("rs_video_linear", 0.02), ("rs_slerp_robust", 0.01)]
OBS_FIELDS = ("uv", "t", "pose_a", "pose_b", "intr_idx", "point", "mask")


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
        scale = max(1.0, np.abs(want).max(initial=0.0))
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * scale)


def test_observations_match_reference(pair):
    ja, tb = pair
    assert int(tb.problem.obs.mask.sum()) == int(np.sum(ja.problem.obs.mask))
    for f in OBS_FIELDS:
        _close(getattr(tb.problem.obs, f), getattr(ja.problem.obs, f))


def test_params_and_masks_match_reference(pair):
    ja, tb = pair
    for f in ("q", "c", "intr", "points"):
        _close(getattr(tb.params0, f), getattr(ja.params0, f))
        _close(getattr(tb.params_gt, f), getattr(ja.params_gt, f))
    for f in ("pose_free", "point_free", "intr_free", "intr_basis"):
        _close(getattr(tb.problem, f), getattr(ja.problem, f))
    assert tb.problem.model.rotation_interp == \
        ja.problem.model.rotation_interp
    assert tb.problem.loss.kind == ja.problem.loss.kind


def test_numpy_bridge_round_trip(pair):
    ja, tb = pair
    prob = ttypes.problem_from_numpy(ja.problem, device="cpu")
    params = ttypes.params_from_numpy(ja.params0, device="cpu")
    for f in OBS_FIELDS:
        _close(getattr(prob.obs, f), getattr(ja.problem.obs, f))
    back = ttypes.to_numpy(params)
    for f in ("q", "c", "intr", "points"):
        np.testing.assert_array_equal(back[f], np.asarray(
            getattr(ja.params0, f)))
    assert ttypes.to_numpy(prob)["obs"]["uv"].shape == \
        tuple(ja.problem.obs.uv.shape)
    assert prob.model == tb.problem.model and prob.loss == tb.problem.loss


def test_validate_problem_rejects_bad_index(pair):
    _, tb = pair
    obs = tb.problem.obs
    bad = obs.replace(point=obs.point.clone())
    bad.point[0] = tb.problem.point_free.numel()
    with pytest.raises(ValueError, match="obs.point out of range"):
        ttypes.validate_problem(tb.problem.replace(obs=bad))
