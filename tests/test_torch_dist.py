"""The port's distributed solvers (rsba_tpu_torch.dist) against the JAX
package's, on the CPU in float64.

One world of 4 gloo ranks (``dist.launch.spawn``, module-scoped) runs
every sharded scenario (``_torch_dist_scenarios.run_all``) on problems
that ``rsba_tpu``'s generator made (tests/test_distributed.py's
``_tiny``), and the rank body of ``entry.dryrun_multichip``; the JAX side runs here on a mesh of 4 of conftest's 8 CPU
devices, so both split the window rows alike.  Tolerances are
tests/test_distributed.py's wherever the port's fused prepare and the
JAX XLA window engine agree that closely, as named in each test; every
rank's results must agree in every bit.
"""
import numpy as np
import pytest
import torch

import _torch_dist_scenarios as scenarios
from rsba_tpu_torch import dist
from rsba_tpu_torch.dist import launch, mesh as tmesh
from rsba_tpu_torch.problem import types as ttypes
from rsba_tpu_torch.solver import SolverOptions, lm, window as twin

try:
    import jax
    import jax.numpy as jnp
    from rsba_tpu import dist as jdist
    from rsba_tpu.problem import synthetic as jsyn
    from rsba_tpu.solver import window as jwin
    from rsba_tpu.solver.options import SolverOptions as JOptions
except ImportError:
    # The card's test at the end needs no JAX; the machine with the card
    # has none (run it there with -m gpu).
    jax = None

torch.set_num_threads(2)
WORLD = 4


def _tiny(seed=0, rolling=True):
    return jsyn.make_ba_problem(
        n_poses=9, n_points=200, track_len=4, rolling_shutter=rolling,
        rotation_interp="slerp", use_distortion=rolling, pixel_noise=0.3,
        seed=seed, dtype=jnp.float64, pad_to=32)


def _port(ba):
    return (ttypes.problem_from_numpy(ba.problem, device="cpu"),
            ttypes.params_from_numpy(ba.params0, device="cpu"))


#: scenario → the seed and shutter of tests/test_distributed.py's problem
SEEDS = {"banded_step": (5, True), "banded_solve": (6, True),
         "flat_step": (1, True), "flat_solve": (2, True), "gs": (4, False)}


@pytest.fixture(scope="module")
def jax_problems():
    return {k: _tiny(seed, rolling) for k, (seed, rolling) in SEEDS.items()}


@pytest.fixture(scope="module")
def world(jax_problems):
    """The 4 ranks' results, in rank order."""
    cases = {k: _port(ba) for k, ba in jax_problems.items()}
    return launch.spawn(scenarios.run_all, WORLD, "gloo", "cpu", cases)


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **kw)


# --- host-side pieces ---------------------------------------------------------

@pytest.mark.parametrize("n_shards,rolling", [(4, True), (3, False)])
def test_repartition_matches_reference(n_shards, rolling):
    ba = _tiny(seed=1, rolling=rolling)
    jp, jx, jinfo = jdist.repartition_by_point(ba.problem, ba.params0,
                                               n_shards=n_shards)
    tp, tx, tinfo = dist.repartition_by_point(*_port(ba), n_shards=n_shards)
    for f in ("uv", "t", "pose_a", "pose_b", "intr_idx", "point", "mask"):
        np.testing.assert_array_equal(getattr(tp.obs, f).numpy(),
                                      np.asarray(getattr(jp.obs, f)), f)
    np.testing.assert_array_equal(tp.point_free.numpy(),
                                  np.asarray(jp.point_free))
    np.testing.assert_array_equal(tx.points.numpy(), np.asarray(jx.points))
    for f in ("n_shards", "m_local", "n_local", "n_points_orig"):
        assert getattr(tinfo, f) == getattr(jinfo, f), f
    np.testing.assert_array_equal(tinfo.point_old2new, jinfo.point_old2new)
    np.testing.assert_array_equal(tinfo.point_new2old, jinfo.point_new2old)
    np.testing.assert_array_equal(
        tinfo.restore_points(tx.points).numpy(), np.asarray(ba.params0.points))


@pytest.mark.parametrize("kw", [dict(nr_multiple=8), dict(nr_multiple=24),
                                dict(nr_multiple=40), dict(max_window=3)],
                         ids=["nr8", "nr24", "nr40", "max_window3"])
def test_build_window_plan_arguments_match_reference(kw):
    """``build_window_plan(problem, max_window, nr_multiple)`` as the
    reference's (the port once had neither argument)."""
    ba = _tiny(seed=5)
    jp = jwin.build_window_plan(ba.problem, **kw)
    tp = twin.build_window_plan(_port(ba)[0], **kw)
    if jp is None:
        assert tp is None
        return
    for f in ("NR", "G", "L", "W", "n_poses", "n_points"):
        assert getattr(tp, f) == getattr(jp, f), f
    assert tp.NR % kw["nr_multiple"] == 0
    for f in ("row_base", "uv", "t", "mask", "offs_a", "rs_ab", "point_id"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), f)


def test_row_blocks_fold_to_the_whole_plan():
    """A plan's row blocks (``WindowPlan.rows``) keep global point ids and
    fold into partial sums over all poses that add up to the whole fold;
    their scattered points add up to the whole problem's."""
    plan = twin.build_window_plan(_port(_tiny(seed=5))[0], nr_multiple=16)
    rng = np.random.RandomState(0)
    v = torch.as_tensor(rng.randn(plan.NR, plan.W, 6))
    pts = torch.as_tensor(rng.randn(plan.n_points, 3))
    fold, scatter = 0.0, 0.0
    for r0 in range(0, plan.NR, 4):
        blk = plan.rows(r0, r0 + 4)
        assert blk.NR == 4 and blk.n_poses == plan.n_poses
        np.testing.assert_array_equal(blk.point_id.numpy(),
                                      plan.point_id[r0:r0 + 4].numpy())
        fold = fold + blk.fold(v[r0:r0 + 4])
        scatter = scatter + blk.scatter_points(blk.gather_points(pts))
    _close(fold, plan.fold(v), rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(scatter.numpy(), pts.numpy())


def test_a_failing_rank_fails_the_world():
    """One rank raises while the other waits in an all-reduce: spawn stops
    the world and raises with the rank's traceback."""
    with pytest.raises(RuntimeError, match="on purpose"):
        launch.spawn(scenarios.fail_on_rank, 2, "gloo", "cpu", 1)


def test_nccl_world_larger_than_the_visible_cards_raises():
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match="NCCL"):
        launch.spawn(scenarios.run_all, n + 1, "nccl", "cuda", {})
    with pytest.raises(ValueError, match="NCCL backend needs a CUDA"):
        tmesh.resolve_backend("nccl", torch.device("cpu"), 1)


@pytest.mark.parametrize("case", ["device_loop_on", "no_window_layout",
                                  "flat_dense"])
def test_sharded_engines_refuse(case):
    """On a world of one rank in this process: the sharded engines have
    no on-device loop (``device_loop="on"`` raises), the banded one
    refuses a problem without a window layout (the CLI then falls back
    to the flat one), and the flat one runs only iterative_schur and
    dense_schur."""
    from rsba_tpu_torch.problem import synthetic
    with launch.single_rank(device="cpu") as mesh:
        assert (mesh.rank, mesh.size, mesh.backend) == (0, 1, "gloo")
        if case == "device_loop_on":
            problem, params0 = _port(_tiny(seed=5))
            opts = SolverOptions(device_loop="on")
            fns = dist.make_sharded_window_solver_fns(problem, opts, mesh)
            with pytest.raises(ValueError, match="device_loop"):
                lm.solve(problem, params0, opts, fns=fns)
        elif case == "no_window_layout":
            ba = synthetic.CONFIGS["gs_bal"](scale=0.04, device="cpu")
            with pytest.raises(ValueError, match="window layout"):
                dist.make_sharded_window_solver_fns(
                    ba.problem, SolverOptions(), mesh)
        else:
            problem, _ = _port(_tiny(seed=5))
            with pytest.raises(ValueError, match="iterative_schur or"):
                dist.make_sharded_solver_fns(
                    problem, SolverOptions(linear_solver="dense"), mesh)


@pytest.mark.parametrize("problem,solver,want", [
    ("window", "auto", "banded_schur"),
    ("window", "dense_schur", "dense_schur"),
    ("flat", "auto", "iterative_schur"),
    ("flat", "banded_schur", ValueError),
])
def test_make_solver_fns_picks_the_engine(problem, solver, want):
    """``dist.make_solver_fns``, the CLI's and ``tools.dist_gpu``'s choice
    of engine, on one rank in this process: the banded engine where the
    problem has the window layout and auto is asked, else the flat one on
    the repartitioned problem (its ``PartitionInfo`` comes back);
    banded_schur without the layout raises."""
    from rsba_tpu_torch.problem import synthetic
    if problem == "window":
        prob, params0 = _port(_tiny(seed=5))
    else:
        ba = synthetic.CONFIGS["gs_bal"](scale=0.04, device="cpu")
        prob, params0 = ba.problem, ba.params0
    opts = SolverOptions(linear_solver=solver)
    with launch.single_rank(device="cpu") as mesh:
        if want is ValueError:
            with pytest.raises(ValueError, match="window layout"):
                dist.make_solver_fns(prob, params0, opts, mesh)
            return
        said = []
        fns, prob2, params2, opts2, info = dist.make_solver_fns(
            prob, params0, opts, mesh, say=said.append)
    assert fns["engine"][0] == want
    banded = want == "banded_schur"
    assert opts2.linear_solver == (solver if banded else want)
    assert (info is None) == banded and (prob2 is prob) == banded
    assert bool(said) == (problem == "flat")
    if not banded:
        np.testing.assert_array_equal(
            info.restore_points(params2.points).numpy(),
            params0.points.numpy())


# --- the world's scenarios ----------------------------------------------------

def test_world_covers_the_rows_once(world):
    assert [r["rank"] for r in world] == list(range(WORLD))
    rows = [r["banded_step"]["rows"] for r in world]
    assert rows[0][0] == 0
    assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
    assert all(r["backend"] == "gloo" and r["size"] == WORLD for r in world)


@pytest.mark.parametrize("name", ["banded_step", "banded_solve", "gs_solve",
                                  "flat_step_iterative_schur",
                                  "flat_solve_iterative_schur",
                                  "flat_step_dense_schur",
                                  "flat_solve_dense_schur", "all_reduce"])
def test_every_rank_agrees_in_every_bit(world, name):
    """The replicated results (cost, step, accept sequence, final cost,
    gathered points) are equal in every bit on every rank."""
    skip = {"rows", "pt_chunk"}
    first = world[0][name]
    for r in world[1:]:
        for k, v in r[name].items():
            if k in skip:
                continue
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(v, first[k], f"{name}.{k}")
            else:
                assert v == first[k], (name, k)


@pytest.mark.parametrize("against", ["jax_sharded", "port_single"])
def test_banded_prepare_and_step(world, jax_problems, against):
    """Cost, gradient, predicted decrease and the step of the banded
    sharded engine against the JAX package's sharded engine (4 of the 8
    CPU devices) and the port's single-device engine, at
    tests/test_distributed.py:122-136's tolerances (cost 1e-12, gradient
    1e-10, predicted 1e-8, step rtol 1e-6 atol 1e-12)."""
    ba = jax_problems["banded_step"]
    got = world[0]["banded_step"]
    assert got["engine"] == ("banded_schur", "torch-sharded")
    if against == "jax_sharded":
        opts = JOptions(linear_solver="banded_schur", max_cg_iterations=300,
                        cg_eta=1e-10)
        fns = jdist.make_sharded_window_solver_fns(
            ba.problem, opts, jdist.make_mesh(jax.devices()[:WORLD]))
        p = fns["to_internal"](ba.params0)
        aux = fns["prepare"](p)
        dx, pred, _ = fns["solve_step"](aux, jnp.asarray(1e4, jnp.float64))
        pt = fns["to_external"](p.replace(points=dx["pt"])).points
    else:
        problem, params0 = _port(ba)
        fns = lm.make_solver_fns(problem, SolverOptions(
            linear_solver="banded_schur", max_cg_iterations=300,
            cg_eta=1e-10))
        p = fns["to_internal"](params0)
        aux = fns["prepare"](p)
        dx, pred, _ = fns["solve_step"](aux, 1e4)
        pt = fns["to_external"](p.replace(points=dx["pt"])).points
    _close(got["cost"], float(aux["cost"]), rtol=1e-12)
    _close(got["gmax"], float(aux["gradient_max_norm"]), rtol=1e-10)
    _close(got["pred"], float(pred), rtol=1e-8)
    _close(got["pose"], np.asarray(dx["pose"]), rtol=1e-6, atol=1e-12)
    _close(got["pt"], np.asarray(pt), rtol=1e-6, atol=1e-12)


def test_banded_full_solve(world, jax_problems):
    """CONVERGENCE through ``banded_schur/torch-sharded``, final RMSE
    within rtol 1e-6 of the port's single-device solve
    (test_sharded_banded_full_solve), points back in the caller's
    order."""
    got = world[0]["banded_solve"]
    assert got["termination"] == "CONVERGENCE", got["message"]
    assert got["engine"] == ("banded_schur", "torch-sharded")
    problem, params0 = _port(jax_problems["banded_solve"])
    params, s = lm.solve(problem, params0, SolverOptions(
        linear_solver="banded_schur", max_iterations=30))
    assert s.termination == "CONVERGENCE"
    _close(got["final_rmse"], s.final_rmse, rtol=1e-6)
    assert got["points"].shape == tuple(params0.points.shape)
    _close(got["points"], params.points.numpy(), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("against", ["jax_sharded", "port_single"])
@pytest.mark.parametrize("solver", ["iterative_schur", "dense_schur"])
def test_flat_prepare_and_step(world, jax_problems, solver, against):
    """The flat sharded engine's prepare and step on the repartitioned
    problem against the JAX package's sharded engine (4 of the 8 CPU
    devices) and the port's single-device engine on it, at
    tests/test_distributed.py:50-76's tolerances (cost 1e-12, gradient
    1e-9, predicted 1e-6, step rtol 1e-5 atol 1e-10)."""
    ba = jax_problems["flat_step"]
    if against == "jax_sharded":
        jprob, jparams, info = jdist.repartition_by_point(
            ba.problem, ba.params0, n_shards=WORLD)
        mesh = jdist.make_mesh(jax.devices()[:WORLD])
        prob_s, params_s = jdist.shard_ba(jprob, jparams, mesh)
        fns = jdist.make_sharded_solver_fns(prob_s, JOptions(
            linear_solver=solver, max_cg_iterations=300, cg_eta=1e-10,
            refinement_steps=1), mesh)
        aux = fns["prepare"](params_s)
        (d_pose, _, d_pt), pred, _ = fns["solve_step"](
            aux, jnp.asarray(1e4, jnp.float64))
    else:
        prob2, params2, info = dist.repartition_by_point(*_port(ba), WORLD)
        fns = lm.make_solver_fns(prob2, SolverOptions(
            linear_solver=solver, max_cg_iterations=300, cg_eta=1e-10,
            refinement_steps=1))
        aux = fns["prepare"](params2)
        dx, pred, _ = fns["solve_step"](aux, 1e4)
        d_pose, _, d_pt = lm.assembly.unflatten_tangent(
            dx, lm.assembly.tangent_shapes(prob2, params2))
    d_pose, d_pt = np.asarray(d_pose), np.asarray(d_pt)
    m = info.m_local
    for r in world:
        got = r[f"flat_step_{solver}"]
        assert got["engine"] == (solver, "torch-flat-sharded")
        _close(got["cost"], float(aux["cost"]), rtol=1e-12)
        _close(got["gmax"], float(aux["gradient_max_norm"]), rtol=1e-9)
        _close(got["pred"], float(pred), rtol=1e-6)
        _close(got["pose"], d_pose, rtol=1e-5, atol=1e-10)
        _close(got["pt_chunk"], d_pt[r["rank"] * m:(r["rank"] + 1) * m],
               rtol=1e-5, atol=1e-10)


@pytest.mark.parametrize("solver", ["iterative_schur", "dense_schur"])
def test_flat_full_solve(world, jax_problems, solver):
    """CONVERGENCE, RMSE rtol 1e-6 and camera centres rtol 1e-4 atol 1e-7
    against the single-device solve on the repartitioned problem
    (test_sharded_solve_equals_single_device)."""
    got = world[0][f"flat_solve_{solver}"]
    assert got["termination"] == "CONVERGENCE", got["message"]
    problem, params0 = _port(jax_problems["flat_solve"])
    prob2, params2, _ = dist.repartition_by_point(problem, params0, WORLD)
    p1, s1 = lm.solve(prob2, params2, SolverOptions(
        linear_solver=solver, max_iterations=30, max_cg_iterations=200,
        cg_eta=1e-6, device_loop="off"))
    assert s1.termination == "CONVERGENCE"
    _close(got["final_rmse"], s1.final_rmse, rtol=1e-6)
    _close(got["c"], p1.c.numpy(), rtol=1e-4, atol=1e-7)


def test_global_shutter_also_works(world, jax_problems):
    """test_sharded_global_shutter_also_works: converges below 1.5× the
    pixel noise."""
    got = world[0]["gs_solve"]
    assert got["termination"] == "CONVERGENCE", got["message"]
    assert got["engine"] == ("iterative_schur", "torch-flat-sharded")
    assert got["final_rmse"] < 1.5 * jax_problems["gs"].pixel_noise


@pytest.mark.parametrize("rank", range(WORLD))
def test_dryrun_multichip_rank(world, rank):
    """``dryrun_multichip``'s rank body (``entry._dryrun_rank``): each rank
    ran both engines on the tiny flagship in float32, held them to the
    single-device step with the reference's float32 tolerances (it raises
    otherwise), and took a cost-decreasing step with each."""
    r = world[rank]["dryrun"]
    assert (r["rank"], r["device"], r["backend"]) == (rank, "cpu", "gloo")
    assert r["engine_banded"] == ("banded_schur", "torch-sharded")
    assert r["engine_flat"] == ("iterative_schur", "torch-flat-sharded")
    assert r["banded_new_cost"] < r["cost"]
    assert r["flat_new_cost"] < r["cost"]


def test_dryrun_ranks_agree(world):
    first = world[0]["dryrun"]
    for r in world[1:]:
        for k in ("cost", "banded_new_cost", "flat_new_cost"):
            assert r["dryrun"][k] == first[k], k


@pytest.mark.gpu
def test_sharded_engines_on_the_card():
    """The card's counterpart: a gloo world of two ranks sharing card 0,
    the banded sharded engine through the CUDA kernel (one launch per
    prepare on each rank) and the flat engine, both converging with equal
    records on both ranks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rsba_tpu_torch.tools import dist_gpu
    for solver, engine in (("auto", "banded_schur/cuda-sharded"),
                           ("iterative_schur",
                            "iterative_schur/torch-flat-sharded")):
        recs = launch.spawn(dist_gpu.solve_rank, 2, "gloo", "cuda", {
            "config": "rs_video_linear", "scale": 0.1, "dtype": "f64",
            "solver": solver})
        for r in recs:
            assert r["engine"] == engine
            assert r["termination"] == "CONVERGENCE"
            if solver == "auto":
                assert r["kernel_launches"] == r["prepares"] > 0
        assert recs[0]["seq"] == recs[1]["seq"]
        assert recs[0]["final_cost"] == recs[1]["final_cost"]
