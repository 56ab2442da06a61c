"""The band's preconditioners and the fixed-order fold of the port.

``cluster_jacobi`` on the band (contiguous pose segments factored dense)
against an explicit dense segment solve and against the reference's
``apply`` on the same band, float64, rel 1e-9; a full tiny solve under it;
``WindowPlan.fold`` giving the same bits twice and ``index_add_``'s sums
at 1e-12.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from rsba_tpu.solver import banded as jbanded
from rsba_tpu_torch.problem import synthetic as tsyn
from rsba_tpu_torch.problem import types as ttypes
from rsba_tpu_torch.solver import (SolverOptions, banded, banded_fused,
                                   make_solver_fns, solve, window)

# The problems are tiny and the test workers run side by side.
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def flagship():
    fl = __graft_entry__._tiny_flagship(jnp.float64)
    return (ttypes.problem_from_numpy(fl.problem, device="cpu"),
            ttypes.params_from_numpy(fl.params0, device="cpu"))


@pytest.fixture(scope="module")
def band(flagship):
    """The damped Schur band (P, W, 6, 6) of the flagship's first step."""
    problem, params0 = flagship
    opts = SolverOptions()
    plan = window.build_window_plan(problem)
    fns = make_solver_fns(problem, opts)
    aux = fns["prepare"](fns["to_internal"](params0))
    return banded_fused.reduced_system(plan, opts, aux, 1e4)[0]


def _dense(Sb):
    P, W = Sb.shape[:2]
    S = np.zeros((P * 6, P * 6))
    for p in range(P):
        for d in range(W):
            if p + d >= P:
                break
            S[p * 6:(p + 1) * 6, (p + d) * 6:(p + d + 1) * 6] += Sb[p, d]
            if d > 0:
                S[(p + d) * 6:(p + d + 1) * 6, p * 6:(p + 1) * 6] += \
                    Sb[p, d].T
    return S


@pytest.mark.parametrize("K", [4, 16, 3])
def test_cluster_jacobi_matches_dense_segments(band, K):
    P = band.shape[0]
    apply = banded.make_band_preconditioner(band, "cluster_jacobi",
                                            segment=K)
    r = np.random.RandomState(1).randn(P * 6)
    z = apply(torch.as_tensor(r)).numpy()
    S = _dense(band.numpy())
    z_ref = np.zeros_like(r)
    for s0 in range(0, P, K):
        s1 = min(s0 + K, P)
        z_ref[s0 * 6:s1 * 6] = np.linalg.solve(
            S[s0 * 6:s1 * 6, s0 * 6:s1 * 6], r[s0 * 6:s1 * 6])
    np.testing.assert_allclose(z, z_ref, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("kind,K", [("cluster_jacobi", 4),
                                    ("cluster_jacobi", 16),
                                    ("schur_jacobi", 16), ("jacobi", 16)])
def test_band_preconditioner_matches_reference_apply(band, kind, K):
    r = np.random.RandomState(2).randn(band.shape[0] * 6)
    z = banded.make_band_preconditioner(band, kind, segment=K)(
        torch.as_tensor(r)).numpy()
    zj = jbanded.make_band_preconditioner(jnp.asarray(band.numpy()), kind,
                                          segment=K)(jnp.asarray(r))
    np.testing.assert_allclose(z, np.asarray(zj), rtol=1e-9,
                               atol=1e-9 * np.abs(z).max())


def test_band_segments_are_principal_blocks(band):
    K = 4
    M = banded.band_segments(band, K).numpy()
    P = band.shape[0]
    S = _dense(band.numpy())
    for s in range(M.shape[0]):
        n = (min((s + 1) * K, P) - s * K) * 6
        np.testing.assert_array_equal(
            M[s, :n, :n], S[s * K * 6:s * K * 6 + n, s * K * 6:s * K * 6 + n])
        np.testing.assert_array_equal(M[s, n:, n:], np.eye(K * 6 - n))
        assert not M[s, :n, n:].any()


def test_band_matvec_is_the_dense_product(band):
    P = band.shape[0]
    x = torch.as_tensor(np.random.RandomState(5).randn(P, 6))
    want = (_dense(band.numpy()) @ x.numpy().reshape(-1)).reshape(P, 6)
    got = banded.make_band_matvec(band)(x.reshape(-1)).reshape(P, 6).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    zj = jbanded.band_matvec(jnp.asarray(band.numpy()),
                             jnp.asarray(x.numpy()))
    np.testing.assert_allclose(got, np.asarray(zj), rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


def test_band_preconditioner_rejects_unknown_kind(band):
    with pytest.raises(ValueError):
        banded.make_band_preconditioner(band, "ssor")


def test_cluster_jacobi_full_solve(flagship):
    problem, params0 = flagship
    out = {}
    for kind in ("cluster_jacobi", "schur_jacobi"):
        _, out[kind] = solve(problem, params0, SolverOptions(
            linear_solver="banded_schur", preconditioner=kind,
            max_iterations=30))
    s_c, s_j = out["cluster_jacobi"], out["schur_jacobi"]
    assert s_c.termination == "CONVERGENCE"
    assert abs(s_c.final_rmse_inlier - s_j.final_rmse_inlier) < 1e-3
    cg = lambda s: sum(i.linear_solver_iterations  # noqa: E731
                       for i in s.iterations)
    assert cg(s_c) <= cg(s_j)


# --- the fold ----------------------------------------------------------------

@pytest.fixture(scope="module")
def plan():
    ba = tsyn.CONFIGS["rs_slerp_robust"](scale=0.02, device="cpu")
    return window.build_window_plan(ba.problem)


def _fold_index_add(plan, v):
    rest = tuple(v.shape[2:])
    out = v.new_zeros((plan.n_poses + plan.W,) + rest)
    out.index_add_(0, plan._win_idx().reshape(-1), v.reshape((-1,) + rest))
    return out[:plan.n_poses]


@pytest.mark.parametrize("rest", [(), (6,), (6, 6)])
def test_fold_has_a_fixed_order_and_matches_index_add(plan, rest):
    v = torch.as_tensor(np.random.RandomState(0).randn(plan.NR, plan.W,
                                                       *rest))
    a, b = plan.fold(v), plan.fold(v.clone())
    assert torch.equal(a, b)
    assert a.shape == (plan.n_poses,) + rest
    ref = _fold_index_add(plan, v)
    np.testing.assert_allclose(a.numpy(), ref.numpy(), rtol=1e-12,
                               atol=1e-12)


def test_fold_is_the_adjoint_of_pose_windows(plan):
    rng = np.random.RandomState(3)
    x = torch.as_tensor(rng.randn(plan.n_poses, 6))
    v = torch.as_tensor(rng.randn(plan.NR, plan.W, 6))
    lhs = torch.sum(plan.pose_windows(x) * v)
    rhs = torch.sum(x * plan.fold(v))
    assert float(lhs) == pytest.approx(float(rhs), rel=1e-12)


def _pose_cells(plan):
    """Each pose's cells from both fold tables, in table order."""
    sentinel = plan.NR * plan.W
    lists = [list(r) for r in plan.fold_idx.numpy()]
    for p, r in zip(plan.heavy_pose.numpy(), plan.heavy_idx.numpy()):
        lists[p] += list(r)
    return [np.asarray([c for c in r if c < sentinel], np.int64)
            for r in lists]


def test_fold_table_lists_every_cell_once(plan):
    lists = _pose_cells(plan)
    cells = np.concatenate(lists)
    assert len(np.unique(cells)) == len(cells)
    pose = (plan.row_base.numpy()[:, None] + np.arange(plan.W)).reshape(-1)
    assert len(cells) == int((pose < plan.n_poses).sum())
    for p in (0, plan.n_poses // 2, plan.n_poses - 1):
        mine = lists[p]
        assert (pose[mine] == p).all() and (np.diff(mine) > 0).all()


@pytest.mark.parametrize("block", ["whole", "first_half", "second_half"])
def test_fold_splits_off_heavy_poses(block):
    """Config 5's points without observations have window base 0, so pose
    0 collects far more cells than any other pose.  Its surplus goes to
    the second table: the two tables hold at most two thirds of the cells
    of one table as wide as the longest list (1.7 to 2.3 times fewer
    here), on the whole plan and on each half of its rows, and the fold
    still equals the index-add fold (rtol 1e-12)."""
    ba = tsyn.CONFIGS["rs_mhost_pcg"](scale=0.02, device="cpu")
    whole = window.build_window_plan(ba.problem, nr_multiple=16)
    h = whole.NR // 2
    plan = {"whole": whole, "first_half": whole.rows(0, h),
            "second_half": whole.rows(h, whole.NR)}[block]
    pose = (plan.row_base[:, None] + torch.arange(plan.W)).reshape(-1)
    k_max = int(torch.bincount(pose[pose < plan.n_poses]).max())
    held = plan.fold_idx.numel() + plan.heavy_idx.numel()
    assert 3 * held <= 2 * plan.n_poses * k_max
    v = torch.as_tensor(np.random.RandomState(1).randn(plan.NR, plan.W, 6))
    np.testing.assert_allclose(plan.fold(v).numpy(),
                               _fold_index_add(plan, v).numpy(),
                               rtol=1e-12, atol=1e-12)
