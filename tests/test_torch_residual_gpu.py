"""The residual-pass CUDA kernel against its plain version on the card
(``gpu`` marker; skipped without one).

``kernels/fused.py::residual_pass_cuda`` computes every slot's robust
cost ρ and the pairwise decrease ½ Σ_valid (ρ_ref − ρ) in one launch.  On
every ``chip_smoke.fixtures()`` problem (each rotation interpolation,
global shutter, distortion on and off, the trivial, Huber, Cauchy and
soft-L1 losses), the pose_b == pose_a and session-shaped variants and
rows wider than a block, it must match the plain version: float64 at
rtol = atol = 1e-9, float32 within 1e-5·max|ρ| plus four times the plain
version's own float32 round-off (``chip_smoke.compare_residual``).  Two
launches give equal bits; padded slots whose sentinel point projects to
NaN leave ρ and the decrease finite; a captured step attempt holds one
launch and the re-prepare none, and ``dense_schur`` launches none.  The
file imports neither jax nor rsba_tpu (from the repo root):

    python -m pytest --noconftest -o addopts= tests/test_torch_residual_gpu.py
"""
import pytest
import torch

import chip_smoke
from rsba_tpu_torch.geometry import camera
from rsba_tpu_torch.kernels import fused
from rsba_tpu_torch.problem import synthetic
from rsba_tpu_torch.solver import (SolverOptions, lm_device, make_solver_fns,
                                   solve)

FIXTURES = ["rs_slerp_huber", "rs_nlerp", "gs_distortion",
            "flagship_slerp_dist_huber", "rs_lerp_aa_cauchy",
            "rs_slerp_soft_l1"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")


def _problem(name, dtype=torch.float64):
    return synthetic.make_ba_problem(dtype=dtype, device="cuda",
                                     **chip_smoke.fixtures()[name])


def test_fixture_names_match_chip_smoke():
    assert FIXTURES == list(chip_smoke.fixtures())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name", FIXTURES)
def test_residual_kernel_matches_plain_version(name, dtype):
    _card()
    chip_smoke.compare_residual(name, _problem(name, dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["same_pose", "session_shaped", "wide"])
def test_residual_kernel_routes(route):
    _card()
    if route == "same_pose":
        chip_smoke.compare_residual(
            route, _problem("flagship_slerp_dist_huber"),
            edit=chip_smoke.same_pose_on_some_slots)
    elif route == "session_shaped":
        chip_smoke.compare_residual(
            route, chip_smoke.session_shaped(_problem("rs_nlerp")))
    else:   # 352 columns a row: one row a block, threads walk the columns
        ba = synthetic.make_ba_problem(dtype=torch.float64, device="cuda",
                                       **chip_smoke.chunked_fixture())
        plan = chip_smoke.kernel_inputs(ba)[0]
        assert plan.G > fused.RESIDUAL_MAX_THREADS
        chip_smoke.compare_residual(route, ba)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_two_launches_give_equal_bits(dtype):
    _card()
    chip_smoke.check_residual_equal_bits(
        _problem("flagship_slerp_dist_huber", dtype))


@pytest.mark.gpu
def test_padded_slots_that_project_to_nan_stay_out():
    _card()
    ba = _problem("gs_distortion")
    _, inp = chip_smoke.residual_inputs(ba)
    inp, (r, l, g) = chip_smoke.padding_on_camera_centres(inp)
    win, pts, uv, tt, mask, offs, rsf, intr = inp
    model, loss = ba.problem.model, ba.problem.loss
    x = camera.project(win[r, 0, :4], win[r, 0, 4:7], win[r, 0, :4],
                       win[r, 0, 4:7], intr, pts[r, :, g], tt[r, l, g], model)
    assert torch.isnan(x).all()
    ref = torch.ones_like(tt)
    rho, dec = fused.residual_pass_cuda(*inp, ref, model=model, loss=loss)
    want_rho, want_dec = fused.residual_pass_reference(*inp, ref, model=model,
                                                       loss=loss)
    assert torch.isfinite(rho).all() and torch.isfinite(dec)
    assert (rho[mask <= 0] == 0).all()
    torch.testing.assert_close(rho, want_rho, rtol=1e-9, atol=1e-9)
    torch.testing.assert_close(dec, want_dec, rtol=1e-9, atol=1e-9)


@pytest.mark.gpu
def test_captured_attempt_holds_one_launch():
    """A banded solve through the captured loop: one launch in the
    attempt's graph and none in the re-prepare's; a second solve on the
    same graphs launches once per attempt and once at its block entry.
    ``dense_schur`` launches none."""
    _card()
    ba = _problem("flagship_slerp_dist_huber")
    opts = SolverOptions(max_iterations=30)
    fns = make_solver_fns(ba.problem, opts)
    solve(ba.problem, ba.params0, opts, fns=fns)
    (runner,) = fns["_device_runners"].values()
    assert lm_device._kernel_counters()[2] is fused.residual_pass_cuda
    assert runner.kernel_nodes[0][2] == 1 and runner.kernel_nodes[1][2] == 0
    attempts = [0]
    real = lm_device._Runner.attempt

    def counted(self):
        attempts[0] += 1
        return real(self)

    fused.residual_pass_cuda.launches = 0
    with pytest.MonkeyPatch.context() as m:
        m.setattr(lm_device._Runner, "attempt", counted)
        _, s = solve(ba.problem, ba.params0, opts, fns=fns)
    assert s.termination == "CONVERGENCE"
    assert fused.residual_pass_cuda.launches == attempts[0] + 1

    gs = _problem("gs_distortion")
    opts = SolverOptions(linear_solver="dense_schur", max_iterations=30)
    fns = make_solver_fns(gs.problem, opts)
    fused.residual_pass_cuda.launches = 0
    solve(gs.problem, gs.params0, opts, fns=fns)
    assert fused.residual_pass_cuda.launches == 0
    for r in fns.get("_device_runners", {}).values():
        assert r.kernel_nodes[0][2] == r.kernel_nodes[1][2] == 0
