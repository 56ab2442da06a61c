"""Covariance and gradient check of rsba_tpu_torch against rsba_tpu.

A gauge-fixed tiny rolling-shutter problem (8 poses, 120 points, two
poses pinned) is solved by the JAX package; at that solution both
packages' ``compute_covariance`` must agree (``pose``, ``point``,
``cam_full`` at rtol 1e-8, ``sigma2_estimate`` at 1e-10), and the port's
must equal the inverse of its own dense Gauss-Newton matrix over the free
dims (rtol 1e-6).  ``check_gradients``: the two reports agree at 1e-6
(absolute: both are finite-difference round-off near 1e-8), a
deliberately wrong Jacobian raises, and ``SolverOptions(check_gradients=
True)`` runs the check inside ``solve``.  In float32 at config 1's full
size the reference's check reads 8e-3, above the 2e-3 that its ``solve``
takes as the float32 default: its differences' round-off on pixel-sized
residuals, not a wrong Jacobian.  The port differences in float64 and
reads 2e-5 there, and still refuses a Jacobian that is 1% wrong.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsba_tpu.problem import synthetic as jsyn
from rsba_tpu.solver import SolverOptions as JOptions
from rsba_tpu.solver import solve as jsolve
from rsba_tpu.solver.covariance import compute_covariance as jcovariance
from rsba_tpu.solver.gradient_check import check_gradients as jcheck
from rsba_tpu_torch.problem import types as ttypes
from rsba_tpu_torch.solver import (SolverOptions, assembly, gradient_check,
                                   residuals, solve)
from rsba_tpu_torch.solver.covariance import compute_covariance
from rsba_tpu_torch.solver.gradient_check import check_gradients

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def solved():
    ba = jsyn.make_ba_problem(
        n_poses=8, n_points=120, track_len=4, rolling_shutter=True,
        rotation_interp="nlerp", pixel_noise=0.5, seed=11,
        dtype=jnp.float64, pad_to=32)
    # The generator fixes pose 0; pose 1 is pinned too, so that the
    # Gauss-Newton matrix over the free dims is positive definite.
    ba.problem = ba.problem.replace(
        pose_free=ba.problem.pose_free.at[1].set(0.0))
    params, s = jsolve(ba.problem, ba.params0,
                       JOptions(linear_solver="dense_schur",
                                max_iterations=30))
    assert s.termination == "CONVERGENCE"
    problem = ttypes.problem_from_numpy(ba.problem, device="cpu")
    return (ba, params, problem,
            ttypes.params_from_numpy(params, device="cpu"),
            ttypes.params_from_numpy(ba.params0, device="cpu"))


def test_covariance_matches_reference(solved):
    ba, jparams, problem, params, _ = solved
    want = jcovariance(ba.problem, jparams)
    got = compute_covariance(problem, params)
    for f in ("pose", "point", "cam_full"):
        w = np.asarray(getattr(want, f))
        np.testing.assert_allclose(getattr(got, f).numpy(), w, rtol=1e-8,
                                   atol=1e-8 * np.abs(w).max())
    assert got.sigma2_estimate == pytest.approx(want.sigma2_estimate,
                                                rel=1e-10)
    # pinned poses are no random variables
    assert not got.pose[:2].any() and got.pose[2:].abs().sum() > 0


def test_covariance_matches_dense_inverse(solved):
    _, _, problem, params, _ = solved
    cov = compute_covariance(problem, params)
    shapes = assembly.tangent_shapes(problem, params)
    ev = residuals.evaluate(params, problem)
    H = assembly.dense_normal_equations(ev, problem, shapes)[0].numpy()
    obs = problem.obs
    counts = np.zeros(shapes.n_points)
    valid = obs.mask.numpy() > 0
    np.add.at(counts, obs.point.numpy()[valid], 1.0)
    free = np.concatenate([
        np.repeat(problem.pose_free.numpy(), 6),
        np.repeat(problem.point_free.numpy() * (counts >= 2), 3)]) > 0
    full = np.zeros_like(H)
    full[np.ix_(free, free)] = np.linalg.inv(H[np.ix_(free, free)])
    P, Dc = shapes.n_poses, shapes.cam_dim
    for p in (0, 3, P - 1):
        np.testing.assert_allclose(cov.pose[p].numpy(),
                                   full[p * 6:(p + 1) * 6, p * 6:(p + 1) * 6],
                                   rtol=1e-6, atol=1e-12)
    for m in (0, 50, 119):
        s = slice(Dc + m * 3, Dc + (m + 1) * 3)
        np.testing.assert_allclose(cov.point[m].numpy(), full[s, s],
                                   rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(cov.cam_full.numpy(), full[:Dc, :Dc],
                               rtol=1e-6, atol=1e-10)
    S = cov.cam_full[12:, 12:]
    assert torch.allclose(S, S.T, rtol=0, atol=1e-12 * float(S.abs().max()))
    assert torch.linalg.eigvalsh(0.5 * (S + S.T)).min() > 0


def test_covariance_refuses_a_large_camera_system(solved):
    _, _, problem, params, _ = solved
    with pytest.raises(ValueError, match="max_cam_dim"):
        compute_covariance(problem, params, max_cam_dim=10)


@pytest.mark.parametrize("which", ["initial", "solution"])
def test_check_gradients_matches_reference(solved, which):
    ba, jparams, problem, params, params0 = solved
    jp, tp = ((ba.params0, params0) if which == "initial"
              else (jparams, params))
    want = jcheck(ba.problem, jp)
    got = check_gradients(problem, tp)
    assert got["n_checked"] == want["n_checked"] == 64
    # both are the differences' round-off, a few 1e-8
    assert got["max_relative_error"] == pytest.approx(
        want["max_relative_error"], abs=1e-6)
    assert got["max_relative_error"] < 1e-6
    # float32: the forward-mode Jacobian's own round-off, about 1e-4,
    # against float64 differences
    p32 = ttypes.problem_from_numpy(ba.problem, device="cpu",
                                    dtype=torch.float32)
    x32 = ttypes.params_from_numpy(jp, device="cpu", dtype=torch.float32)
    rep = check_gradients(p32, x32, relative_precision=5e-2)
    assert 1e-6 < rep["max_relative_error"] < 2e-3


def test_float32_check_at_config1_size_passes_in_the_port_only():
    """50 poses, 5,000 points, float32, at the initial parameters (where
    ``solve`` checks) and at the ground truth (residuals of the pixel
    noise).  The reference differences in float32 and reads between
    2e-3 and 2e-2, so its float32 default of 2e-3 refuses this correct
    Jacobian.  The port differences in float64: it reads below 2e-4 on
    the same sample, its float32 ``solve(check_gradients=True)`` passes
    at the default, and J_pt scaled by 1.01 still raises."""
    ba = jsyn.CONFIGS["gs_small"](scale=1.0, dtype=jnp.float32)
    assert ba.params0.q.dtype == jnp.float32
    problem = ttypes.problem_from_numpy(ba.problem, device="cpu",
                                        dtype=torch.float32)
    x0 = ttypes.params_from_numpy(ba.params0, device="cpu",
                                  dtype=torch.float32)
    assert x0.n_poses == 50 and x0.n_points == 5000
    want = jcheck(ba.problem, ba.params0, relative_precision=2e-2)
    got = check_gradients(problem, x0, relative_precision=2e-4)
    assert got["n_checked"] == want["n_checked"] == 64
    assert 2e-3 < want["max_relative_error"] < 2e-2
    assert got["max_relative_error"] < 2e-4
    with pytest.raises(ValueError, match="gradient check FAILED"):
        jcheck(ba.problem, ba.params0, relative_precision=2e-3)
    _, s = solve(problem, x0, SolverOptions(linear_solver="dense_schur",
                                            max_iterations=1,
                                            check_gradients=True))
    assert s.num_iterations == 1
    # the same Jacobian in float64 passes at 1e-5
    p64 = ttypes.problem_from_numpy(ba.problem, device="cpu",
                                    dtype=torch.float64)
    x64 = ttypes.params_from_numpy(ba.params0, device="cpu",
                                   dtype=torch.float64)
    assert check_gradients(p64, x64)["max_relative_error"] < 1e-5
    xgt = ttypes.params_from_numpy(ba.params_gt, device="cpu",
                                   dtype=torch.float32)
    rep = jcheck(ba.problem, ba.params_gt, relative_precision=2e-2)
    assert 2e-3 < rep["max_relative_error"] < 2e-2
    assert check_gradients(problem, xgt, relative_precision=2e-4)[
        "max_relative_error"] < 2e-4
    evaluate = residuals.evaluate
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gradient_check.residuals, "evaluate",
                   lambda params, problem: evaluate(params, problem)._replace(
                       J_pt=evaluate(params, problem).J_pt * 1.01))
        with pytest.raises(ValueError, match="gradient check FAILED"):
            check_gradients(problem, x0, relative_precision=2e-3)


def test_check_gradients_raises_on_a_wrong_jacobian(solved, monkeypatch):
    _, _, problem, _, params0 = solved
    evaluate = residuals.evaluate

    def wrong(params, problem):
        ev = evaluate(params, problem)
        return ev._replace(J_pt=ev.J_pt * 1.01)

    monkeypatch.setattr(gradient_check.residuals, "evaluate", wrong)
    with pytest.raises(ValueError, match="gradient check FAILED"):
        check_gradients(problem, params0)
    # float32 at its default of 2e-3: the wrong Jacobian reads 1e-2
    p32 = ttypes.problem_from_numpy(problem, device="cpu",
                                    dtype=torch.float32)
    x32 = params0.astype(torch.float32)
    with pytest.raises(ValueError, match="gradient check FAILED"):
        check_gradients(p32, x32, relative_precision=2e-3)
    monkeypatch.undo()
    assert check_gradients(p32, x32, relative_precision=2e-3)[
        "max_relative_error"] < 2e-4
    # no valid observation: nothing to check
    empty = problem.replace(obs=problem.obs.replace(
        mask=torch.zeros_like(problem.obs.mask)))
    assert check_gradients(empty, params0)["n_checked"] == 0


def test_solve_runs_the_gradient_check(solved, monkeypatch):
    _, _, problem, _, params0 = solved
    calls = []
    inner = gradient_check.check_gradients

    def spy(problem, params, relative_precision=1e-5, **kw):
        calls.append(relative_precision)
        return inner(problem, params, relative_precision, **kw)

    monkeypatch.setattr(gradient_check, "check_gradients", spy)
    opts = SolverOptions(linear_solver="dense_schur", max_iterations=2,
                         check_gradients=True)
    solve(problem, params0, opts)
    solve(problem, params0, dataclasses.replace(
        opts, gradient_check_relative_precision=1e-4))
    assert calls == [1e-5, 1e-4]
    solve(problem, params0, dataclasses.replace(opts, check_gradients=False))
    assert len(calls) == 2
    # float32 takes the wider default
    p32 = ttypes.problem_from_numpy(problem, device="cpu",
                                    dtype=torch.float32)
    x32 = ttypes.params_from_numpy(params0, device="cpu",
                                   dtype=torch.float32)
    monkeypatch.setattr(gradient_check, "check_gradients",
                        lambda p, x, relative_precision: calls.append(
                            relative_precision))
    solve(p32, x32, opts)
    assert calls[-1] == 2e-3

