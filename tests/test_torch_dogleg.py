"""The port's dogleg trust-region strategy (rsba_tpu_torch/solver/dogleg.py):
dogleg and LM share their fixed points, retries reuse the factorization,
inexact solvers are refused, and the step follows the dogleg path; the
cached Gauss-Newton and Cauchy quantities match the reference's, float64.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsba_tpu.problem import synthetic as jsyn
from rsba_tpu.solver import dogleg as jdogleg
from rsba_tpu.solver.options import SolverOptions as JOptions
from rsba_tpu_torch.problem import synthetic as tsyn
from rsba_tpu_torch.problem import types as ttypes
from rsba_tpu_torch.solver import SolverOptions, dogleg, solve
from rsba_tpu_torch.solver.dogleg import make_dogleg_solver

# The problems are tiny and the test workers run side by side.
torch.set_num_threads(2)


@pytest.mark.parametrize("name,scale,solver", [
    ("gs_small", 0.2, "dense"),
    ("gs_bal", 0.05, "dense_schur"),
])
def test_dogleg_matches_lm(name, scale, solver):
    ba = tsyn.CONFIGS[name](scale=scale, seed=0, device="cpu")
    _, s_lm = solve(ba.problem, ba.params0,
                    SolverOptions(linear_solver=solver, max_iterations=40))
    _, s_dl = solve(ba.problem, ba.params0,
                    SolverOptions(linear_solver=solver,
                                  trust_region_strategy="dogleg",
                                  max_iterations=40))
    assert s_dl.evaluator == "torch-flat-dogleg"
    assert s_lm.termination == "CONVERGENCE", s_lm.message
    assert s_dl.termination == "CONVERGENCE", s_dl.message
    assert s_dl.final_rmse_inlier == pytest.approx(
        s_lm.final_rmse_inlier, rel=1e-3)
    assert s_dl.final_cost == pytest.approx(s_lm.final_cost, rel=1e-4)
    assert s_dl.num_iterations <= 2 * s_lm.num_iterations + 5
    assert s_dl.host_reads == 0              # dogleg keeps the host loop


def test_dogleg_cheap_retries_reuse_factorization():
    """A tiny initial radius: the first accepted steps follow several
    blends of one prepare's cached points, and no retry prepares again."""
    ba = tsyn.CONFIGS["gs_small"](scale=0.1, seed=1, device="cpu")
    opts = SolverOptions(linear_solver="dense",
                         trust_region_strategy="dogleg",
                         initial_radius=1e-4, max_iterations=40)
    from rsba_tpu_torch.solver import make_solver_fns
    fns = make_solver_fns(ba.problem, opts)
    calls = {"prepare": 0, "solve_step": 0}
    for k in calls:
        def counted(*a, _f=fns[k], _k=k):
            calls[_k] += 1
            return _f(*a)
        fns[k] = counted
    params, s = solve(ba.problem, ba.params0, opts, fns=fns)
    assert s.termination == "CONVERGENCE", s.message
    assert s.final_rmse_inlier < 1.7 * ba.pixel_noise
    assert calls["solve_step"] == s.num_iterations
    assert calls["prepare"] <= s.num_successful_steps + 1


def test_dogleg_rejects_inexact_solvers():
    ba = tsyn.CONFIGS["gs_small"](scale=0.2, seed=0, device="cpu")
    for solver in ("iterative_schur", "auto", "banded_schur"):
        opts = SolverOptions(linear_solver=solver,
                             trust_region_strategy="dogleg")
        with pytest.raises(ValueError, match="exact step"):
            solve(ba.problem, ba.params0, opts)


@pytest.mark.parametrize("solver", ["dense", "dense_schur"])
def test_dogleg_step_geometry_and_reference(solver):
    """GN inside the radius → the GN step; a tiny radius → the scaled
    Cauchy direction (parallel to −g); and the cached points equal the
    reference's."""
    jba = jsyn.CONFIGS["gs_small"](scale=0.06, seed=2, dtype=jnp.float64)
    problem = ttypes.problem_from_numpy(jba.problem, device="cpu")
    params0 = ttypes.params_from_numpy(jba.params0, device="cpu")
    kw = dict(linear_solver=solver, trust_region_strategy="dogleg")
    prepare, solve_step = make_dogleg_solver(problem, SolverOptions(**kw))
    aux = prepare(params0)
    n_gn = float(torch.linalg.vector_norm(aux["dx_gn"]))
    dx, pred, _ = solve_step(aux, 10.0 * n_gn)
    np.testing.assert_allclose(dx.numpy(), aux["dx_gn"].numpy())
    assert float(pred) > 0
    tiny = 1e-6 * n_gn
    dx2, pred2, _ = solve_step(aux, torch.tensor(tiny, dtype=torch.float64))
    g = aux["g_flat"].numpy()
    cos = -np.dot(dx2.numpy(), g) / (np.linalg.norm(dx2.numpy())
                                     * np.linalg.norm(g))
    assert cos == pytest.approx(1.0, abs=1e-8)
    assert np.linalg.norm(dx2.numpy()) == pytest.approx(tiny, rel=1e-6)
    assert float(pred2) > 0

    jprep, jstep = jdogleg.make_dogleg_solver(jba.problem, JOptions(**kw))
    jaux = jprep(jba.params0)
    np.testing.assert_allclose(g, np.asarray(jaux["g_flat"]), rtol=1e-8,
                               atol=1e-8 * np.abs(g).max())
    assert float(aux["gHg"]) == pytest.approx(float(jaux["gHg"]), rel=1e-8)
    # The blend at half the GN step's length.
    mid = 0.5 * n_gn
    dx3, pred3, _ = solve_step(aux, mid)
    jdx3, jpred3, _ = jstep(jaux, jnp.asarray(mid, jnp.float64))
    assert float(torch.linalg.vector_norm(dx3)) == pytest.approx(mid,
                                                                 rel=1e-9)
    # The Gauss-Newton point is the solution of a system damped at 1e-8
    # of its diagonal: along the gauge directions two float64 solvers
    # agree to ~1e-6 of the step's length only.
    np.testing.assert_allclose(dx3.numpy(), np.asarray(jdx3), rtol=1e-5,
                               atol=2e-5 * mid)
    assert float(pred3) == pytest.approx(float(jpred3), rel=1e-5)


def test_update_radius_rules():
    o = SolverOptions(max_radius=50.0)
    up = dogleg.update_radius_dogleg
    assert up(8.0, 0.1, 1.0, True, o) == 4.0        # poor but accepted
    assert up(8.0, 0.5, 1.0, True, o) == 8.0
    assert up(8.0, 0.9, 4.0, True, o) == 12.0       # very good: ≥ 3‖step‖
    assert up(8.0, 0.9, 40.0, True, o) == 50.0      # capped
    assert up(8.0, -1.0, 1.0, False, o) == 4.0      # rejected
    o_j = JOptions(max_radius=50.0)
    for args in ((8.0, 0.1, 1.0, True), (8.0, 0.9, 4.0, True),
                 (8.0, -1.0, 1.0, False)):
        assert up(*args, o) == jdogleg.update_radius_dogleg(*args, o_j)
