"""The banded residual pass (``kernels/fused.py::residual_pass``) on the CPU.

``csrc/fused_evaluate_assemble.cu`` holds a second kernel beside the fused
one: every slot's robust cost ρ and the pairwise decrease
½ Σ_valid (ρ_ref − ρ) on a candidate's parameters.  Its slot arithmetic and
row prologue are ``__host__ __device__``, so ``g++`` builds it as plain C++
(a sequential loop) and ``kernels.fused._run_residual`` calls it on CPU
tensors: every ``chip_smoke.fixtures()`` problem in float64 must match the
plain version at rtol = atol = 1e-9.  The wrapper on CPU tensors is the
plain version; through it the on-device loop's ``cost_decrease_pair`` must
equal the host loop's ``banded.cost_decrease`` (the plain residual path on
the window layout) to 1e-12 relative, for every camera model and loss.
The kernel itself runs on a card (tests/test_torch_residual_gpu.py).
"""
import ctypes
import shutil
import subprocess

import pytest
import torch

import chip_smoke
from rsba_tpu_torch.geometry import camera
from rsba_tpu_torch.kernels import build, fused
from rsba_tpu_torch.problem import synthetic
from rsba_tpu_torch.solver import (SolverOptions, banded, banded_fused,
                                   lm_device, make_solver_fns)

# The problems are tiny and the test workers run side by side.
torch.set_num_threads(2)

FIXTURES = list(chip_smoke.fixtures())


def residual_inputs(ba):
    """(plan, statics, planes params, residual-pass inputs less ρ_ref)."""
    plan, statics, params, inp = chip_smoke.kernel_inputs(ba)
    return plan, statics, params, inp[:2] + inp[3:]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source as C++")
    out = tmp_path_factory.mktemp("residual_host") / "libresidual_host.so"
    src = build.CSRC_DIR / "fused_evaluate_assemble.cu"
    proc = subprocess.run(
        [gxx, "-x", "c++", "-O1", "-shared", "-fPIC", "-o", str(out),
         str(src)], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(out))


def _problem(name, dtype=torch.float64):
    return synthetic.make_ba_problem(dtype=dtype, device="cpu",
                                     **chip_smoke.fixtures()[name])


@pytest.mark.parametrize("with_ref", [True, False], ids=["rho_ref", "none"])
@pytest.mark.parametrize("name", FIXTURES)
def test_host_build_matches_plain_version(host_lib, name, with_ref):
    ba = _problem(name)
    plan, _, _, inp = residual_inputs(ba)
    model, loss = ba.problem.model, ba.problem.loss
    rho_ref = (torch.rand((plan.NR, plan.L, plan.G), dtype=torch.float64,
                          generator=torch.Generator().manual_seed(1))
               if with_ref else None)
    rho, dec = fused.residual_pass_reference(*inp, rho_ref, model=model,
                                             loss=loss)
    out = fused._run_residual(host_lib, 0, *inp, rho_ref, model, loss)
    assert out["rho"].shape == (plan.NR, plan.L, plan.G)
    assert out["dec"].shape == (plan.NR,)
    torch.testing.assert_close(out["rho"], rho, rtol=1e-9, atol=1e-9)
    torch.testing.assert_close(out["dec"].sum(), dec, rtol=1e-9, atol=1e-9)
    # Padded slots hold 0 in both.
    assert (out["rho"][inp[4] <= 0] == 0).all()


@pytest.mark.parametrize("route", ["same_pose", "session_shaped"])
def test_host_build_routes(host_lib, route):
    """pose_b == pose_a on part of the slots, and a problem as a bucketed
    session poses it (constant and dummy poses and points)."""
    if route == "same_pose":
        ba = _problem("flagship_slerp_dist_huber")
        plan, statics, params, full = chip_smoke.kernel_inputs(ba)
        full = chip_smoke.same_pose_on_some_slots(full)
        inp = full[:2] + full[3:]
        assert float(inp[6].min()) == 0.0 and float(inp[6].max()) == 1.0
    else:
        ba = chip_smoke.session_shaped(_problem("rs_nlerp"))
        plan, _, _, inp = residual_inputs(ba)
        assert plan.n_poses == 12 and plan.n_points == 104
    model, loss = ba.problem.model, ba.problem.loss
    rho, dec = fused.residual_pass_reference(*inp, None, model=model,
                                             loss=loss)
    out = fused._run_residual(host_lib, 0, *inp, None, model, loss)
    assert torch.isfinite(out["rho"]).all()
    torch.testing.assert_close(out["rho"], rho, rtol=1e-9, atol=1e-9)
    torch.testing.assert_close(out["dec"].sum(), dec, rtol=1e-9, atol=1e-9)


def test_padded_slots_that_project_to_nan_stay_out(host_lib):
    """Padded slots whose point sits on their camera's centre project to
    0/0 in the plain arithmetic; both versions skip them before any."""
    ba = _problem("flagship_slerp_dist_huber")
    plan, _, _, inp = residual_inputs(ba)
    inp, (r, l, g) = chip_smoke.padding_on_camera_centres(inp)
    win, pts, uv, tt, mask, offs, rsf, intr = inp
    model, loss = ba.problem.model, ba.problem.loss
    x = camera.project(win[r, 0, :4], win[r, 0, 4:7], win[r, 0, :4],
                       win[r, 0, 4:7], intr, pts[r, :, g], tt[r, l, g], model)
    assert torch.isnan(x).all()
    ref = torch.ones((plan.NR, plan.L, plan.G), dtype=torch.float64)
    rho, dec = fused.residual_pass_reference(*inp, ref, model=model,
                                             loss=loss)
    out = fused._run_residual(host_lib, 0, *inp, ref, model, loss)
    for r, d in ((rho, dec), (out["rho"], out["dec"].sum())):
        assert torch.isfinite(r).all() and torch.isfinite(d)
        assert (r[mask <= 0] == 0).all()
    torch.testing.assert_close(out["dec"].sum(), dec, rtol=1e-9, atol=1e-9)


def test_wrapper_on_cpu_tensors_is_the_plain_version():
    ba = _problem("rs_lerp_aa_cauchy")
    plan, _, _, inp = residual_inputs(ba)
    model, loss = ba.problem.model, ba.problem.loss
    ref = torch.rand((plan.NR, plan.L, plan.G), dtype=torch.float64)
    got = fused.residual_pass(*inp, ref, model=model, loss=loss)
    want = fused.residual_pass_reference(*inp, ref, model=model, loss=loss)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        fused.residual_pass_cuda(*inp, ref, model=model, loss=loss)
    with pytest.raises(ValueError, match="rho_ref"):
        fused._check_residual(*inp, ref[:, :, 1:])


@pytest.mark.parametrize("NR,W,G,itemsize,want", [
    (10920, 9, 112, 4, (224, 2, 5460)),      # config 5
    (1096, 11, 112, 4, (224, 2, 548)),       # config 4
    (40, 9, 112, 8, (128, 1, 40)),           # a small window: more blocks
    (300, 5, 352, 8, (256, 1, 300)),         # rows wider than a block
    (4000, 4, 24, 4, (96, 4, 1000)),        # 8 rows would leave 500 blocks
])
def test_residual_plan(NR, W, G, itemsize, want):
    p = fused.residual_plan(NR, W, G, itemsize)
    assert (p.threads, p.rows_per_block, p.blocks) == want
    assert p.threads % 32 == 0 and p.threads <= fused.RESIDUAL_MAX_THREADS
    assert p.rows_per_block == 1 or p.rows_per_block * G <= p.threads
    assert p.smem_bytes <= fused.RESIDUAL_SMEM_BLOCK


MODELS = ["rs_slerp_huber", "rs_nlerp", "gs_distortion",
          "rs_lerp_aa_cauchy", "rs_slerp_soft_l1"]


@pytest.mark.parametrize("name", MODELS)
def test_cost_decrease_pair_equals_host_loop_decrease(name):
    """One LM step's pair of parameters: the loop's pairwise decrease,
    through the wrapper, equals ``banded.cost_decrease``."""
    ba = _problem(name)
    plan, statics, params, _ = residual_inputs(ba)
    problem = ba.problem
    fns = make_solver_fns(problem, SolverOptions(linear_solver="banded_schur"))
    assert fns["engine"] == ("banded_schur", "torch")
    aux = fns["prepare"](params)
    dx, predicted, _ = fns["solve_step"](aux, 1e3)
    cand = fns["apply_step"](params, dx)[0]
    rho_ref = banded_fused.rho_slots(plan, problem, params, statics)
    assert rho_ref.shape == (plan.NR, plan.L, plan.G)
    dec, rho_new = banded_fused.cost_decrease_pair(plan, problem, rho_ref,
                                                   cand, statics)
    want = banded.cost_decrease(plan, problem, banded_fused._as_v1(params),
                                banded_fused._as_v1(cand))
    assert float(want) > 0
    assert float(dec) == pytest.approx(float(want), rel=1e-12)
    # ρ_new is the candidate's ρ: differencing it against itself is 0, and
    # half its sum is the candidate's cost.
    same, _ = banded_fused.cost_decrease_pair(plan, problem, rho_new, cand,
                                              statics)
    assert float(same) == 0.0
    assert 0.5 * float(rho_new.sum()) == pytest.approx(
        float(fns["cost"](cand)), rel=1e-12)


def test_device_loop_runs_the_residual_pass(monkeypatch):
    """The loop's attempt and block entry go through the residual pass,
    carry ρ_ref in the statics' layout, and end as the host loop does."""
    ba = _problem("flagship_slerp_dist_huber")
    calls = []
    real = fused.residual_pass_reference

    def counted(*a, **k):
        calls.append(a[8] is None)
        return real(*a, **k)

    monkeypatch.setattr(fused, "residual_pass_reference", counted)
    opts = SolverOptions(max_iterations=30, device_loop="on")
    fns = make_solver_fns(ba.problem, opts)
    from rsba_tpu_torch.solver import solve
    _, s_dev = solve(ba.problem, ba.params0, opts, fns=fns)
    runner, = fns["_device_runners"].values()
    plan = fns["raw"]["bound"][0]
    assert runner.state.rho_ref.shape == (plan.NR, plan.L, plan.G)
    # one ρ seed a block (rho_ref None), then one pass an attempt
    assert calls[0] and calls.count(True) >= 1
    assert calls.count(False) >= s_dev.num_iterations
    assert lm_device._kernel_counters()[2] is fused.residual_pass_cuda
    monkeypatch.setattr(fused, "residual_pass_reference", real)
    _, s_host = solve(ba.problem, ba.params0,
                      SolverOptions(max_iterations=30, device_loop="off"))
    assert s_dev.termination == s_host.termination
    assert ([it.accepted for it in s_dev.iterations]
            == [it.accepted for it in s_host.iterations])
    assert s_dev.final_cost == pytest.approx(s_host.final_cost, rel=1e-9)
