"""The port's dogleg trust-region strategy (rsba_tpu_torch/solver/dogleg.py):
dogleg and LM share their fixed points, retries reuse the factorization,
inexact solvers are refused, and the step follows the dogleg path; the
cached Gauss-Newton and Cauchy quantities match the reference's, float64.
In float32 the port's Gauss-Newton damping (from the dtype's resolution,
raised while the point fails) and its end at the optimum (a rejected
Gauss-Newton step that predicts no resolvable decrease) converge on
config 1 in a few attempts where the reference does not converge.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsba_tpu.problem import synthetic as jsyn
from rsba_tpu.solver import dogleg as jdogleg
from rsba_tpu.solver import solve as jsolve
from rsba_tpu.solver.options import SolverOptions as JOptions
from rsba_tpu_torch.problem import synthetic as tsyn
from rsba_tpu_torch.problem import types as ttypes
from rsba_tpu_torch.solver import SolverOptions, dogleg, make_solver_fns, solve
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


def test_float64_dogleg_rejecting_gauss_newton_steps_matches_reference():
    """Far from the optimum the full Gauss-Newton step is rejected ten
    times before the first accepted one.  In float64 the port keeps the
    reference's rules (halve the radius, retry the same point until it
    lies outside), so attempts, radii and costs are the reference's."""
    jba = jsyn.CONFIGS["gs_small"](scale=0.06, seed=2, dtype=jnp.float64)
    rng = np.random.RandomState(1)
    p0 = jba.params0
    p0 = p0.replace(
        points=p0.points + jnp.asarray(rng.randn(*p0.points.shape) * 0.5),
        c=p0.c.at[1:].add(jnp.asarray(rng.randn(p0.c.shape[0] - 1, 3)
                                      * 0.1)))
    kw = dict(linear_solver="dense", trust_region_strategy="dogleg",
              initial_radius=1e4, max_iterations=30)
    _, want = jsolve(jba.problem, p0, JOptions(device_loop="off", **kw))
    _, got = solve(ttypes.problem_from_numpy(jba.problem, device="cpu"),
                   ttypes.params_from_numpy(p0, device="cpu"),
                   SolverOptions(**kw))
    assert want.termination == got.termination == "CONVERGENCE"
    seq = [it.accepted for it in want.iterations]
    assert seq[:11] == [False] * 10 + [True]
    assert [it.accepted for it in got.iterations] == seq
    np.testing.assert_allclose(
        [it.trust_region_radius for it in got.iterations],
        [it.trust_region_radius for it in want.iterations], rtol=1e-6)
    assert got.final_cost == pytest.approx(want.final_cost, rel=1e-12)


@pytest.fixture(scope="module")
def rmse_f64():
    """The reference's float64 solve of config 1, seed 0, by scale: the
    RMSE that the port's float32 dogleg solves must reach.  Its LM solve
    through ``dense_schur`` compiles fastest; its float64 dogleg ends at
    the same RMSE to 1e-14 px."""
    cache = {}

    def at(scale):
        if scale not in cache:
            ba = jsyn.CONFIGS["gs_small"](scale=scale, seed=0,
                                          dtype=jnp.float64)
            _, s = jsolve(ba.problem, ba.params0, JOptions(
                linear_solver="dense_schur", device_loop="off",
                max_iterations=50))
            assert s.termination == "CONVERGENCE", s.message
            cache[scale] = s.final_rmse_inlier
        return cache[scale]
    return at


#: attempts, accepted and rejected, that a float32 dogleg solve of config 1
#: may take (float64 takes 3 to 4; a fixed radius of 1e5 took up to 40)
MAX_ATTEMPTS_F32 = 12


def assert_float32_solve(scale, solver, rmse):
    ba = tsyn.CONFIGS["gs_small"](scale=scale, seed=0, dtype=torch.float32,
                                  device="cpu")
    _, s = solve(ba.problem, ba.params0, SolverOptions(
        linear_solver=solver, trust_region_strategy="dogleg",
        max_iterations=50))
    assert s.termination == "CONVERGENCE", s.message
    assert s.evaluator == "torch-flat-dogleg"
    assert s.num_iterations <= MAX_ATTEMPTS_F32, [
        it.accepted for it in s.iterations]
    assert abs(s.final_rmse_inlier - rmse) <= 0.002


@pytest.mark.parametrize("solver", ["dense", "dense_schur"])
def test_float32_dogleg_converges(rmse_f64, solver):
    """The float32 solve ends at the reference's float64 RMSE in a few
    attempts, accepted and rejected: at the optimum a rejected
    Gauss-Newton step that predicts less than the float32 cost resolves
    ends the solve, where halving the radius repeated it."""
    assert_float32_solve(0.1, solver, rmse_f64(0.1))


@pytest.mark.parametrize("threads", [1, 2, 4, 8])
@pytest.mark.parametrize("solver", ["dense", "dense_schur"])
def test_float32_dogleg_converges_under_threads(rmse_f64, solver, threads):
    """The order of the float32 sums changes with the thread count; each
    order ends in a few attempts (a fixed radius of 1e5 took 3 to 40)."""
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        assert_float32_solve(0.1, solver, rmse_f64(0.1))
    finally:
        torch.set_num_threads(before)


@pytest.mark.parametrize("solver", ["dense", "dense_schur"])
def test_float32_dogleg_converges_at_scale_0_2(rmse_f64, solver):
    """The size at which a fixed radius of 1e5 took 35 attempts."""
    assert_float32_solve(0.2, solver, rmse_f64(0.2))


@pytest.mark.parametrize("sign", [1.0, -1.0], ids=["positive", "negative"])
def test_rejected_gauss_newton_step_at_the_optimum_converges(sign):
    """At a float32 solution the full Gauss-Newton step predicts next to
    nothing.  Rejected (the cost is made to rise), it ends the solve in
    CONVERGENCE at the first attempt, whether its prediction is positive
    or not; a prediction of 0 or below was an invalid step, which
    shrank the radius until FAILURE, as it still does in float64."""
    ba = tsyn.CONFIGS["gs_small"](scale=0.06, seed=2, dtype=torch.float32,
                                  device="cpu")
    opts = SolverOptions(linear_solver="dense",
                         trust_region_strategy="dogleg", max_iterations=20)
    x, s0 = solve(ba.problem, ba.params0, opts)
    assert s0.termination == "CONVERGENCE", s0.message
    fns = make_solver_fns(ba.problem, opts)
    step = fns["solve_step"]

    def signed_step(aux, radius):
        dx, pred, it = step(aux, radius)
        return dx, sign * pred, it

    fns["solve_step"] = signed_step
    fns["cost_decrease"] = lambda a, b: torch.tensor(-1e-9,
                                                     dtype=torch.float64)
    _, s = solve(ba.problem, x, opts, fns=fns)
    assert s.termination == "CONVERGENCE", s.message
    assert s.message.startswith(
        "function tolerance reached: the Gauss-Newton step predicts")
    assert [it.accepted for it in s.iterations] == [False]
    assert s.final_cost == pytest.approx(s0.final_cost, rel=1e-12)


def test_rejected_gauss_newton_point_halves_below_itself():
    """Δ ← ½·min(Δ, ‖step‖) after a rejected full Gauss-Newton step, so
    that the next attempt is a new point; other steps keep Ceres's
    rules."""
    o = SolverOptions(max_radius=50.0)
    up = dogleg.update_radius_dogleg
    assert up(8.0, -1.0, 1.0, False, o, True) == 0.5
    assert up(8.0, -1.0, 20.0, False, o, True) == 4.0
    assert up(8.0, -1.0, 1.0, False, o, False) == 4.0
    assert up(8.0, 0.9, 4.0, True, o, True) == 12.0


def test_gauss_newton_damping_grows_while_the_point_fails(monkeypatch):
    """μ starts at max(1e-8, eps): the reference's radius 1e8 in float64,
    2^23 in float32.  A failed point is solved again at 10·μ, the next
    Jacobian starts from μ/5, and when every point fails the step
    follows the Cauchy segment."""
    assert dogleg.gn_start_radius(torch.float64) == jdogleg._GN_RADIUS
    assert dogleg.gn_start_radius(torch.float32) == 2.0 ** 23
    from rsba_tpu_torch.solver import dense
    make = dense.make_dense_solver
    limit = [2e6]

    def failing(problem, options, **kw):
        prepare, solve_step = make(problem, options, **kw)

        def step(aux, radius):
            dx, pred, it = solve_step(aux, radius)
            if radius > limit[0]:
                dx = torch.full_like(dx, torch.nan)
            return dx, pred, it
        return prepare, step

    monkeypatch.setattr(dense, "make_dense_solver", failing)
    ba = tsyn.CONFIGS["gs_small"](scale=0.06, seed=2, device="cpu")
    prepare, solve_step = make_dogleg_solver(ba.problem, SolverOptions(
        linear_solver="dense", trust_region_strategy="dogleg"))
    aux = prepare(ba.params0)
    assert aux["gn_radius"] == pytest.approx(1e6)       # 1e8, 1e7, 1e6
    assert aux["gn_solves"] == 3
    assert torch.isfinite(aux["gn_norm"])
    assert prepare(ba.params0)["gn_radius"] == pytest.approx(5e5)
    limit[0] = 0.0
    aux = prepare(ba.params0)
    assert aux["gn_radius"] == pytest.approx(2.5e6 / 10 ** 5)
    assert aux["gn_norm"] == torch.inf
    dx, pred, _ = solve_step(aux, 1e30)
    g = aux["g_flat"]
    cos = -torch.dot(dx, g) / (torch.linalg.vector_norm(dx)
                               * torch.linalg.vector_norm(g))
    assert float(cos) == pytest.approx(1.0, abs=1e-10)
    assert float(pred) > 0


def test_float32_dogleg_of_the_reference_fails():
    """The reference extracts its Gauss-Newton point at radius 1e8 in
    every dtype, below float32's resolution of the diagonal: on the same
    problem it ends far from the optimum (50 iterations: 36 attempts,
    4.94 px; capped here at 10)."""
    ba = jsyn.CONFIGS["gs_small"](scale=0.1, seed=0, dtype=jnp.float32)
    _, s = jsolve(ba.problem, ba.params0, JOptions(
        linear_solver="dense_schur", trust_region_strategy="dogleg",
        device_loop="off", max_iterations=10))
    assert s.termination == "NO_CONVERGENCE", s.message
    assert s.final_rmse_inlier > 2.0
