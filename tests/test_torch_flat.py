"""The port's flat engines against the reference, float64, on the CPU.

For ``dense``, ``dense_schur`` and ``iterative_schur`` (plain Jacobi,
Schur-Jacobi and the visibility-clustered preconditioner): one
``prepare``'s cost and gradient max-norm at rel 1e-8, one ``solve_step``'s
step and predicted decrease at rel 1e-8 (1e-6 for the CG engines, whose
step is the inexact solution after the same number of iterations), on
``gs_small`` at scale 0.2 and ``gs_bal`` (per-camera optimizable
intrinsics) at scale 0.02.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsba_tpu.problem import synthetic as jsyn
from rsba_tpu.solver import lm as jlm
from rsba_tpu.solver.options import SolverOptions as JOptions
from rsba_tpu_torch.problem import types as ttypes
from rsba_tpu_torch.solver import (SolverOptions, assembly, flatplan,
                                   make_solver_fns, residuals, schur)

# The problems are tiny and the test workers run side by side.
torch.set_num_threads(2)

PROBLEMS = {"gs_small": ("gs_small", 0.2, 0), "gs_bal": ("gs_bal", 0.02, 1)}


@pytest.fixture(scope="module")
def problems():
    out = {}
    for key, (name, scale, seed) in PROBLEMS.items():
        ba = jsyn.CONFIGS[name](scale=scale, seed=seed, dtype=jnp.float64)
        out[key] = (ba, ttypes.problem_from_numpy(ba.problem, device="cpu"),
                    ttypes.params_from_numpy(ba.params0, device="cpu"))
    return out


def test_bridges_carry_per_camera_intrinsics(problems):
    ba, problem, params0 = problems["gs_bal"]
    K = ba.params0.intr.shape[0]
    assert K == ba.params0.q.shape[0] > 1
    assert tuple(params0.intr.shape) == (K, 9)
    assert problem.intr_tangent_dim == 3
    assert tuple(problem.intr_free.shape) == (K,)
    np.testing.assert_array_equal(problem.obs.intr_idx.numpy(),
                                  np.asarray(ba.problem.obs.intr_idx))
    back = ttypes.to_numpy(params0)
    np.testing.assert_array_equal(back["intr"], np.asarray(ba.params0.intr))


CASES = [("dense", "schur_jacobi", "gs_small"),
         ("dense", "schur_jacobi", "gs_bal"),
         ("dense_schur", "schur_jacobi", "gs_small"),
         ("dense_schur", "schur_jacobi", "gs_bal"),
         ("iterative_schur", "jacobi", "gs_small"),
         ("iterative_schur", "schur_jacobi", "gs_small"),
         ("iterative_schur", "schur_jacobi", "gs_bal"),
         ("iterative_schur", "cluster_jacobi", "gs_small"),
         ("iterative_schur", "cluster_jacobi", "gs_bal")]


@pytest.mark.parametrize("solver,precond,key", CASES,
                         ids=["-".join(c) for c in CASES])
def test_prepare_and_step_match_reference(problems, solver, precond, key):
    ba, problem, params0 = problems[key]
    kw = dict(linear_solver=solver, preconditioner=precond)
    jf = jlm.make_solver_fns(ba.problem, JOptions(device_loop="off", **kw))
    tf = make_solver_fns(problem, SolverOptions(**kw))
    assert tf["engine"] == (solver, "torch-flat")
    assert "raw" in tf and "to_internal" not in tf
    aux_j = jf["prepare"](ba.params0)
    aux_t = tf["prepare"](params0)
    assert float(aux_t["cost"]) == pytest.approx(float(aux_j["cost"]),
                                                 rel=1e-10)
    assert float(aux_t["gradient_max_norm"]) == pytest.approx(
        float(aux_j["gradient_max_norm"]), rel=1e-8)
    tol = 1e-8 if solver != "iterative_schur" else 1e-6
    for radius in (1e4, 10.0):
        dx_j, pred_j, li_j = jf["solve_step"](aux_j,
                                              jnp.asarray(radius, jnp.float64))
        dx_t, pred_t, li_t = tf["solve_step"](aux_t, radius)
        dx_j = np.asarray(dx_j)
        np.testing.assert_allclose(dx_t.numpy(), dx_j, rtol=tol,
                                   atol=tol * np.abs(dx_j).max())
        assert float(pred_t) == pytest.approx(float(pred_j), rel=tol)
        assert int(li_t) == int(li_j)
        # A 0-dim tensor radius (the on-device loop's) gives the same step.
        dx_r, _, _ = tf["solve_step"](
            aux_t, torch.tensor(radius, dtype=torch.float64))
        assert torch.equal(dx_r, dx_t)
    cand_j, sn_j, xn_j = jf["apply_step"](ba.params0, jnp.asarray(dx_j))
    cand_t, sn_t, xn_t = tf["apply_step"](params0, dx_t)
    assert float(sn_t) == pytest.approx(float(sn_j), rel=tol)
    assert float(xn_t) == pytest.approx(float(xn_j), rel=1e-12)
    np.testing.assert_allclose(cand_t.q.numpy(), np.asarray(cand_j.q),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(cand_t.intr.numpy(), np.asarray(cand_j.intr),
                               rtol=tol, atol=tol)
    dec_j = float(jf["cost_decrease"](ba.params0, cand_j))
    dec_t = float(tf["cost_decrease"](params0, cand_t))
    assert dec_t == pytest.approx(dec_j, rel=10 * tol)
    rho = tf["raw"]["rho_slots"]((), params0)
    dec_p, _ = tf["raw"]["cost_decrease_pair"]((), rho, cand_t)
    assert float(dec_p) == pytest.approx(dec_t, rel=1e-12)


def _step(make, problem, params, radius, options):
    prepare, solve_step = make(problem, options)
    dx, pred, _ = solve_step(prepare(params), radius)
    return dx.numpy(), float(pred)


@pytest.mark.parametrize("key", ["gs_small", "gs_bal"])
def test_schur_step_equals_dense_step(problems, key):
    """The Schur-eliminated step must equal the full dense LM step."""
    from rsba_tpu_torch.solver.dense import make_dense_solver
    _, problem, params0 = problems[key]
    opts = SolverOptions(refinement_steps=2)
    for radius in (1e4, 1.0):
        dx_d, pred_d = _step(lambda p, o: make_dense_solver(p, o, True),
                             problem, params0, radius, opts)
        dx_s, pred_s = _step(schur.make_dense_schur_solver, problem, params0,
                             radius, opts)
        scale = np.linalg.norm(dx_d)
        np.testing.assert_allclose(dx_s, dx_d, atol=1e-8 * max(scale, 1.0),
                                   rtol=1e-6)
        assert pred_s == pytest.approx(pred_d, rel=1e-8)


def test_gn_hessian_apply_matches_dense(problems):
    """Matrix-free J̃ᵀJ̃x == dense (J̃ᵀJ̃)x: the PCG building block."""
    _, problem, params0 = problems["gs_bal"]
    shapes = assembly.tangent_shapes(problem, params0)
    assert shapes == assembly.static_shapes(problem)
    plans = flatplan.build_flat_plans(problem)
    ev = residuals.evaluate(params0, problem)
    H, g = assembly.dense_normal_equations(ev, problem, shapes)
    x = torch.as_tensor(np.random.RandomState(0).randn(shapes.total_dim))
    Dc = shapes.cam_dim
    hx_cam, hx_pt = schur.gn_hessian_apply(
        ev, problem, shapes, plans, x[:Dc],
        x[Dc:].reshape(shapes.n_points, 3))
    got = torch.cat([hx_cam, hx_pt.reshape(-1)]).numpy()
    want = (H @ x).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-8,
                               atol=1e-8 * max(1.0, np.abs(want).max()))
    # The block assembly agrees with the dense H and g as well.
    B = schur.assemble_B(ev, problem, shapes, plans)
    np.testing.assert_allclose(B.numpy(), H[:Dc, :Dc].numpy(), rtol=1e-9,
                               atol=1e-9 * float(H.abs().max()))
    A = schur.assemble_E(ev, problem, shapes, plans)
    E = H[:Dc, Dc:].reshape(Dc, shapes.n_points, 3).permute(1, 2, 0)
    np.testing.assert_allclose(A.numpy(), E.numpy(), rtol=1e-9,
                               atol=1e-9 * float(H.abs().max()))
    g_pose, g_intr, g_pt = assembly.gradient_blocks(ev, problem, shapes,
                                                    plans)
    np.testing.assert_allclose(
        assembly.flatten_tangent(g_pose, g_intr, g_pt).numpy(), g.numpy(),
        rtol=1e-9, atol=1e-9 * float(g.abs().max()))
    parts = assembly.unflatten_tangent(g, shapes)
    assert [tuple(p.shape) for p in parts] == [
        (shapes.n_poses, 6), (shapes.n_intr, 3), (shapes.n_points, 3)]


@pytest.mark.parametrize("max_slot", [512, 3])
def test_group_plan_sums_in_a_fixed_order(max_slot):
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 7, size=200)
    ids[ids == 5] = 0                      # an empty segment and a busy one
    plan = flatplan.build_group_plan(ids, 7, "cpu", max_slot=max_slot)
    assert (plan.seg_rows is None) == (max_slot == 512)
    x = torch.as_tensor(rng.randn(200, 2, 3))
    got = plan.reduce(x)
    assert torch.equal(got, plan.reduce(x.clone()))
    want = torch.zeros(7, 2, 3, dtype=x.dtype).index_add_(
        0, torch.as_tensor(ids), x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12)
    assert not got[5].any()
