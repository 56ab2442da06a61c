"""Whole-solve parity and package boundaries of rsba_tpu_torch.

A tiny flagship problem (rolling-shutter SLERP + distortion + Huber, the
config-4 feature set) is solved by ``rsba_tpu.solver.lm.solve`` (window
engine, host loop) and by ``rsba_tpu_torch.solver.solve`` (host loop) in
float64:
same termination, LM iterations within 1, final cost rtol 1e-6, inlier
RMSE within 1e-4 px.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import pytest
import torch

import __graft_entry__
from rsba_tpu.solver import lm as jlm
from rsba_tpu.solver.options import SolverOptions as JOptions
from rsba_tpu_torch.problem import synthetic as tsyn
from rsba_tpu_torch.problem import types as ttypes
from rsba_tpu_torch.solver import SolverOptions, make_solver_fns, solve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(max_iterations=30, max_cg_iterations=100, cg_eta=1e-2)


@pytest.fixture(scope="module")
def flagship():
    return __graft_entry__._tiny_flagship(jnp.float64)


def test_tiny_solve_matches_reference(flagship):
    _, sj = jlm.solve(flagship.problem, flagship.params0,
                      JOptions(evaluator="xla", device_loop="off", **KW))
    problem = ttypes.problem_from_numpy(flagship.problem, device="cpu")
    params0 = ttypes.params_from_numpy(flagship.params0, device="cpu")
    params, st = solve(problem, params0,
                       SolverOptions(device_loop="off", **KW))
    assert (st.linear_solver, st.evaluator) == ("banded_schur", "torch")
    assert st.termination == sj.termination == "CONVERGENCE"
    assert abs(st.num_iterations - sj.num_iterations) <= 1
    assert st.final_cost == pytest.approx(sj.final_cost, rel=1e-6)
    assert abs(st.final_rmse_inlier - sj.final_rmse_inlier) < 1e-4
    assert st.initial_cost == pytest.approx(sj.initial_cost, rel=1e-12)
    assert st.num_residuals == sj.num_residuals
    assert st.num_parameters_tangent == sj.num_parameters_tangent
    assert params.points.shape == params0.points.shape
    assert torch.isfinite(params.points).all()


def test_readme_usage_converges():
    """The README's Python usage with the package name changed."""
    ba = tsyn.CONFIGS["rs_slerp_robust"](scale=0.01, device="cpu")
    calls = []
    params, s = solve(ba.problem, ba.params0, SolverOptions(),
                      callback=lambda i, p, it: calls.append(i))
    assert s.termination == "CONVERGENCE", s.message
    assert s.final_rmse_inlier < 1.7 * ba.pixel_noise
    assert len(calls) == s.num_successful_steps > 0
    assert "rsba_tpu_torch solver" in s.brief_report()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("opts,engine", [
    (dict(linear_solver="dense", trust_region_strategy="dogleg"),
     ("dense", "torch-flat-dogleg")),
    (dict(linear_solver="dense_schur"),
     ("dense_schur", "torch-flat+device_loop")),
    (dict(linear_solver="iterative_schur"),
     ("iterative_schur", "torch-flat+device_loop")),
    (dict(preconditioner="cluster_jacobi"),
     ("banded_schur", "torch+device_loop")),
    (dict(device_loop="on"), ("banded_schur", "torch+device_loop")),
    (dict(evaluator="pallas"), ValueError),
], ids=["dogleg", "dense_schur", "iterative_schur", "cluster_jacobi",
        "device_loop_on", "bad_evaluator"])
def test_unported_options_raise(flagship, opts, engine):
    """Every solver option resolves to its engine and solves (each of
    these raised NotImplementedError while its module was missing); an
    evaluator the port does not have is still refused."""
    problem = ttypes.problem_from_numpy(flagship.problem, device="cpu")
    params0 = ttypes.params_from_numpy(flagship.params0, device="cpu")
    if engine is ValueError:
        with pytest.raises(ValueError):
            solve(problem, params0, SolverOptions(max_iterations=2, **opts))
        return
    _, s = solve(problem, params0, SolverOptions(max_iterations=30, **opts))
    assert (s.linear_solver, s.evaluator) == engine
    assert s.termination == "CONVERGENCE", s.message
    assert s.final_rmse_inlier < 1.7 * flagship.pixel_noise


def test_bad_options_raise(flagship):
    problem = ttypes.problem_from_numpy(flagship.problem, device="cpu")
    params0 = ttypes.params_from_numpy(flagship.params0, device="cpu")
    with pytest.raises(ValueError, match="exact step"):
        solve(problem, params0, SolverOptions(trust_region_strategy="dogleg"))
    with pytest.raises(ValueError, match="device_loop"):
        solve(problem, params0, SolverOptions(
            linear_solver="dense", trust_region_strategy="dogleg",
            device_loop="on"))


def test_flat_problem_raises_not_implemented():
    """gs_bal's optimizable intrinsics do not fit the window layout:
    ``auto`` resolves to the flat iterative_schur engine, and
    ``banded_schur`` refuses."""
    ba = tsyn.CONFIGS["gs_bal"](scale=0.04, device="cpu")
    fns = make_solver_fns(ba.problem, SolverOptions())
    assert fns["engine"] == ("iterative_schur", "torch-flat")
    with pytest.raises(ValueError, match="window/track structure"):
        make_solver_fns(ba.problem, SolverOptions(
            linear_solver="banded_schur"))


def test_import_leaves_jax_out():
    """Importing the whole port loads neither jax nor rsba_tpu."""
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]); "
        "import rsba_tpu_torch, rsba_tpu_torch.solver, "
        "rsba_tpu_torch.solver.banded_fused, rsba_tpu_torch.kernels.fused, "
        "rsba_tpu_torch.kernels.band_pcg, "
        "rsba_tpu_torch.kernels.build, rsba_tpu_torch.problem.synthetic, "
        "rsba_tpu_torch.solver.lm_device, rsba_tpu_torch.solver.residuals, "
        "rsba_tpu_torch.solver.assembly, rsba_tpu_torch.solver.flatplan, "
        "rsba_tpu_torch.solver.dense, rsba_tpu_torch.solver.schur, "
        "rsba_tpu_torch.solver.pcg, rsba_tpu_torch.solver.cluster, "
        "rsba_tpu_torch.solver.dogleg, "
        "rsba_tpu_torch.solver.covariance, "
        "rsba_tpu_torch.solver.gradient_check, rsba_tpu_torch.solver.p3p, "
        "rsba_tpu_torch.solver.pnp, rsba_tpu_torch.solver.ransac, "
        "rsba_tpu_torch.geometry.epipolar, "
        "rsba_tpu_torch.geometry.triangulate, rsba_tpu_torch.io.bal, "
        "rsba_tpu_torch.utils.checkpoint, rsba_tpu_torch.utils.roofline, "
        "rsba_tpu_torch.pipeline.session, rsba_tpu_torch.cli.run, "
        "rsba_tpu_torch.tools.pipeline_gpu, rsba_tpu_torch.dist, "
        "rsba_tpu_torch.dist.mesh, rsba_tpu_torch.dist.partition, "
        "rsba_tpu_torch.dist.launch, rsba_tpu_torch.dist.banded_sharded, "
        "rsba_tpu_torch.dist.sharded, rsba_tpu_torch.entry, "
        "rsba_tpu_torch.tools.dist_gpu; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'orbax', 'rsba_tpu')); "
        "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-I", "-c", code, REPO],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_chip_smoke_fails_without_a_card():
    """chip_smoke.py never carries on on the CPU and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no CUDA device" in out.stderr
