"""Whole solves through the port's flat engines, float64, on the CPU:
the reference's termination and final cost on tiny problems, the
visibility clusters and their blocks of S, the ``auto`` fallback and the
two size guards.
"""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsba_tpu.io import bal
from rsba_tpu.problem import synthetic as jsyn
from rsba_tpu.solver import cluster as jcluster
from rsba_tpu.solver import flatplan as jflatplan
from rsba_tpu.solver import solve as jsolve
from rsba_tpu.solver.options import SolverOptions as JOptions
from rsba_tpu_torch.problem import synthetic as tsyn
from rsba_tpu_torch.problem import types as ttypes
from rsba_tpu_torch.solver import (SolverOptions, assembly, cluster, dense,
                                   flatplan, make_solver_fns, residuals,
                                   schur, solve)

# The problems are tiny and the test workers run side by side.
torch.set_num_threads(2)

BAL_SAMPLE = (pathlib.Path(__file__).parent.parent / "benchmarks" / "data"
              / "bal_ring12.txt.gz")


def _port(problem, params):
    return (ttypes.problem_from_numpy(problem, device="cpu"),
            ttypes.params_from_numpy(params, device="cpu"))


@pytest.fixture(scope="module")
def gs_small():
    return jsyn.CONFIGS["gs_small"](scale=0.1, seed=1, dtype=jnp.float64)


@pytest.fixture(scope="module")
def bal_problem():
    return bal.load_bal(str(BAL_SAMPLE), dtype=jnp.float64)


SOLVES = [("dense", "schur_jacobi"), ("dense_schur", "schur_jacobi"),
          ("iterative_schur", "schur_jacobi"),
          ("iterative_schur", "cluster_jacobi")]


@pytest.mark.parametrize("solver,precond", SOLVES,
                         ids=["-".join(c) for c in SOLVES])
def test_tiny_solve_ends_like_the_reference(gs_small, solver, precond):
    kw = dict(linear_solver=solver, preconditioner=precond,
              max_iterations=30)
    _, sj = jsolve(gs_small.problem, gs_small.params0,
                   JOptions(device_loop="off", **kw))
    problem, params0 = _port(gs_small.problem, gs_small.params0)
    params, st = solve(problem, params0, SolverOptions(**kw))
    assert (st.linear_solver, st.evaluator) == (solver,
                                                "torch-flat+device_loop")
    assert st.termination == sj.termination == "CONVERGENCE"
    assert st.message.split(":")[0] == sj.message.split(":")[0]
    assert st.num_iterations == sj.num_iterations
    assert st.final_cost == pytest.approx(sj.final_cost, rel=1e-8)
    assert st.final_rmse_inlier == pytest.approx(sj.final_rmse_inlier,
                                                 rel=1e-6)
    assert st.final_rmse_inlier < 1.7 * gs_small.pixel_noise
    assert st.num_parameters_tangent == sj.num_parameters_tangent
    assert params.points.shape == params0.points.shape


def test_per_camera_intrinsics_solve_recovers_focal():
    ba = tsyn.make_ba_problem(
        n_poses=6, n_points=300, track_len=6, rolling_shutter=False,
        use_distortion=True, per_camera_intrinsics=True,
        optimize_intrinsics=True, pixel_noise=0.5, seed=2, device="cpu")
    params, s = solve(ba.problem, ba.params0, SolverOptions(
        linear_solver="dense_schur", max_iterations=50))
    assert s.termination == "CONVERGENCE", s.message
    assert s.final_rmse < 0.75
    f_err = (params.intr[:, 0] - ba.params_gt.intr[:, 0]).abs()
    assert float((f_err / ba.params_gt.intr[:, 0]).median()) < 5e-3


def test_auto_falls_back_to_flat_without_window_structure():
    ba = tsyn.CONFIGS["gs_bal"](scale=0.02, seed=1, device="cpu")
    fns = make_solver_fns(ba.problem, SolverOptions())
    assert fns["engine"] == ("iterative_schur", "torch-flat")
    assert "to_internal" not in fns
    _, s = solve(ba.problem, ba.params0, SolverOptions(max_iterations=30),
                 fns=fns)
    assert s.termination == "CONVERGENCE", s.message
    assert s.linear_solver == "iterative_schur"
    with pytest.raises(ValueError, match="window/track structure"):
        make_solver_fns(ba.problem,
                        SolverOptions(linear_solver="banded_schur"))


def test_size_guards(monkeypatch):
    ba = tsyn.CONFIGS["gs_small"](scale=0.1, seed=1, device="cpu")
    assert dense.materializes_dense(ba.problem)
    prepare, _ = dense.make_dense_solver(ba.problem, SolverOptions())
    assert "H" in prepare(ba.params0)
    # Above the guard the dense engine eliminates the points instead.
    monkeypatch.setattr(dense, "_DENSE_MATERIALIZE_MAX_ELEMS", 1000)
    assert not dense.materializes_dense(ba.problem)
    prepare, _ = dense.make_dense_solver(ba.problem, SolverOptions())
    assert "A" in prepare(ba.params0)
    # dense_schur refuses what would not fit.
    monkeypatch.setattr(schur, "_DENSE_SCHUR_MAX_BYTES", 1000)
    with pytest.raises(ValueError, match="dense_schur would materialize"):
        schur.make_dense_schur_solver(ba.problem, SolverOptions())
    with pytest.raises(ValueError, match="iterative_schur"):
        make_solver_fns(ba.problem, SolverOptions(linear_solver="dense"))


# --- visibility clusters -----------------------------------------------------

def test_clusters_equal_the_reference(bal_problem):
    jproblem, jparams = bal_problem
    problem, _ = _port(jproblem, jparams)
    plans = flatplan.build_flat_plans(problem, pairs=False)
    ids = cluster.cluster_cameras(problem, plans.point, max_size=4)
    jplans = jflatplan.build_flat_plans(jproblem, jproblem.intr_tangent_dim)
    np.testing.assert_array_equal(
        ids, jcluster.cluster_cameras(jproblem, jplans.point, max_size=4))
    _, counts = np.unique(ids, return_counts=True)
    assert counts.max() <= 4 and len(counts) < ids.shape[0]
    cp = cluster.build_cluster_plan(problem, plans.point, max_size=4)
    jcp = jcluster.build_cluster_plan(jproblem, jplans.point, max_size=4)
    np.testing.assert_array_equal(cp.pose_table.numpy(),
                                  np.asarray(jcp.pose_table))
    assert cp.pair_i.shape[0] == jcp.pair_i.shape[0]


def test_cluster_blocks_are_principal_submatrices_of_S(bal_problem):
    """Each cluster block must equal the corresponding principal
    submatrix of the reduced camera system S = B − E C⁻¹ Eᵀ, assembled
    densely for this small problem."""
    problem, params = _port(*bal_problem)
    shapes = assembly.static_shapes(problem)
    plans = flatplan.build_flat_plans(problem)
    ev = residuals.evaluate(params, problem)
    C = assembly.point_hessian_blocks(ev, plans)
    C_inv = schur.invert_3x3_psd(C + 1e-9 * torch.eye(3, dtype=C.dtype))
    B = schur.assemble_B(ev, problem, shapes, plans)
    A = schur.assemble_E(ev, problem, shapes, plans)
    S = B - torch.einsum("mad,mae->de", A,
                         torch.einsum("mab,mbd->mad", C_inv, A))
    cp = cluster.build_cluster_plan(problem, plans.point, max_size=4)
    P = shapes.n_poses
    D_pose = torch.stack([S[p * 6:(p + 1) * 6, p * 6:(p + 1) * 6]
                          for p in range(P)])
    blocks = cluster.cluster_blocks(cp, D_pose, ev, C_inv).numpy()
    ids, loc = cp.cluster_of.numpy(), cp.local_of.numpy()
    S = S.numpy()
    for c in range(cp.n_clusters):
        members = np.nonzero(ids == c)[0]
        for p in members:
            for q in members:
                S_true = S[p * 6:(p + 1) * 6, q * 6:(q + 1) * 6]
                blk = blocks[c, loc[p] * 6:(loc[p] + 1) * 6,
                             loc[q] * 6:(loc[q] + 1) * 6]
                np.testing.assert_allclose(blk, S_true, rtol=1e-9,
                                           atol=1e-9 * abs(S_true).max())
        pad = 6 * len(members)
        np.testing.assert_array_equal(blocks[c, pad:, pad:],
                                      np.eye(blocks.shape[1] - pad))


def test_cluster_jacobi_full_solve_converges(bal_problem):
    problem, params = _port(*bal_problem)
    _, s = solve(problem, params, SolverOptions(
        linear_solver="iterative_schur", preconditioner="cluster_jacobi",
        max_cg_iterations=200, cg_eta=1e-2, max_iterations=30))
    assert s.termination == "CONVERGENCE"
