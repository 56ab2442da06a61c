"""The port's on-device LM loop (rsba_tpu_torch/solver/lm_device.py).

On the CPU the loop's attempt function runs eagerly; it is the function a
CUDA graph captures on the card.  It must reproduce the port's host loop
(same termination, same counts, costs at rel 1e-9, radii at rel 1e-6) and
the reference's on-device loop (same termination and accept sequence,
record columns at rel 1e-6, final cost at rel 1e-8), float64.  ``pcg``
must run without reading a scalar back and return the reference's
``(x, r, iters)``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from rsba_tpu.problem import synthetic as jsyn
from rsba_tpu.solver import SolverOptions as JOptions
from rsba_tpu.solver import pcg as jpcg
from rsba_tpu.solver import solve as jsolve
from rsba_tpu_torch.kernels import band_pcg
from rsba_tpu_torch.problem import synthetic as tsyn
from rsba_tpu_torch.problem import types as ttypes
from rsba_tpu_torch.solver import (SolverOptions, lm_device, make_solver_fns,
                                   solve)
from rsba_tpu_torch.solver import pcg as tpcg

# The problems are tiny and the test workers run side by side.
torch.set_num_threads(2)


def _port(ba):
    return (ttypes.problem_from_numpy(ba.problem, device="cpu"),
            ttypes.params_from_numpy(ba.params0, device="cpu"))


@pytest.fixture(scope="module")
def config4_small():
    return jsyn.CONFIGS["rs_slerp_robust"](scale=0.02, seed=0,
                                           dtype=jnp.float64)


@pytest.fixture(scope="module")
def port_loop(config4_small):
    problem, params0 = _port(config4_small)
    return solve(problem, params0,
                 SolverOptions(max_iterations=40, device_loop="auto"))


def test_device_loop_matches_host_loop(config4_small, port_loop):
    problem, params0 = _port(config4_small)
    _, s_host = solve(problem, params0,
                      SolverOptions(max_iterations=40, device_loop="off"))
    p_dev, s_dev = port_loop
    assert s_dev.evaluator == "torch+device_loop"
    assert s_host.evaluator == "torch"
    assert s_host.termination == s_dev.termination == "CONVERGENCE"
    assert s_host.num_iterations == s_dev.num_iterations
    assert s_host.num_successful_steps == s_dev.num_successful_steps
    assert s_host.num_unsuccessful_steps == s_dev.num_unsuccessful_steps
    assert s_dev.final_cost == pytest.approx(s_host.final_cost, rel=1e-9)
    assert s_dev.final_rmse_inlier == pytest.approx(
        s_host.final_rmse_inlier, rel=1e-9)
    for a, b in zip(s_host.iterations, s_dev.iterations):
        assert a.accepted == b.accepted
        assert a.cost == pytest.approx(b.cost, rel=1e-9)
        assert a.trust_region_radius == pytest.approx(
            b.trust_region_radius, rel=1e-6)
        assert a.linear_solver_iterations == b.linear_solver_iterations
    # One small tensor per attempt and one per block; no phase times.
    assert s_dev.host_reads <= s_dev.num_iterations + 3
    assert s_dev.evaluation_time == s_dev.linear_solver_time == 0.0
    assert p_dev.points.shape == params0.points.shape


def test_device_loop_matches_reference_loop(config4_small, port_loop):
    _, sj = jsolve(config4_small.problem, config4_small.params0,
                   JOptions(linear_solver="auto", max_iterations=40,
                            device_loop="auto"))
    _, st = port_loop
    assert sj.evaluator.endswith("+device_loop")
    assert st.termination == sj.termination
    assert st.message.split(":")[0] == sj.message.split(":")[0]
    assert ([i.accepted for i in st.iterations]
            == [i.accepted for i in sj.iterations])
    # Every column of the record table, while the radius is below its cap.
    # Once it has reached 1e16 the damping is gone, the gauge directions
    # amplify round-off (two float64 engines with different summation
    # orders then differ by up to 1e-3 in a step's cost change), and only
    # the accepted costs stay comparable.
    early = [i for i, it in enumerate(sj.iterations)
             if it.trust_region_radius < 1e10]
    assert len(early) >= 8
    for a, b in zip(st.iterations, sj.iterations):
        assert a.cost == pytest.approx(b.cost, rel=1e-8)
    for i in early:
        a, b = st.iterations[i], sj.iterations[i]
        for f in ("cost", "cost_change", "gradient_max_norm", "step_norm",
                  "relative_decrease", "trust_region_radius"):
            assert getattr(a, f) == pytest.approx(getattr(b, f), rel=1e-6,
                                                  abs=1e-12), (i, f)
        assert a.linear_solver_iterations == b.linear_solver_iterations
    assert st.initial_cost == pytest.approx(sj.initial_cost, rel=1e-12)
    assert st.final_cost == pytest.approx(sj.final_cost, rel=1e-8)


def test_device_loop_blocks_fire_callback():
    seen = []
    ba = tsyn.CONFIGS["rs_video_linear"](scale=0.05, seed=0, device="cpu")
    opts = SolverOptions(max_iterations=8, device_block_iters=1,
                         function_tolerance=0.0, gradient_tolerance=0.0,
                         parameter_tolerance=0.0)
    fns = make_solver_fns(ba.problem, opts)
    params, s = solve(ba.problem, ba.params0, opts, fns=fns,
                      callback=lambda i, p, it: seen.append(
                          (i, it.cost, p.points.shape)))
    # One callback per accepted record, labels strictly increasing, the
    # params argument in the caller's layout; blocks of 4 attempts.
    assert len(seen) == s.num_successful_steps >= 2
    assert [i for i, _, _ in seen] == sorted({i for i, _, _ in seen})
    assert all(shape == ba.params0.points.shape for _, _, shape in seen)
    (key, runner), = fns["_device_runners"].items()
    assert key[0] == runner.block_attempts == 4
    assert s.host_reads > s.num_iterations      # several blocks
    # A second solve on the same fns finds its runner again.
    solve(ba.problem, ba.params0, opts, fns=fns,
          callback=lambda i, p, it: None)
    assert list(fns["_device_runners"].values()) == [runner]


def test_device_loop_on_requires_raw_engine():
    ba = tsyn.CONFIGS["gs_small"](scale=0.2, seed=0, device="cpu")
    opts = SolverOptions(linear_solver="dense", device_loop="on",
                         trust_region_strategy="dogleg")
    with pytest.raises(ValueError, match="device_loop"):
        solve(ba.problem, ba.params0, opts)


def test_device_loop_flat_engines_match_host():
    ba = tsyn.CONFIGS["gs_small"](scale=0.2, seed=0, device="cpu")
    outs = {}
    for dl in ("off", "on"):
        opts = SolverOptions(linear_solver="dense", max_iterations=30,
                             device_loop=dl)
        _, outs[dl] = solve(ba.problem, ba.params0, opts)
    assert outs["on"].evaluator == "torch-flat+device_loop"
    assert outs["off"].evaluator == "torch-flat"
    assert outs["off"].termination == outs["on"].termination
    assert outs["off"].num_iterations == outs["on"].num_iterations
    assert outs["on"].final_cost == pytest.approx(outs["off"].final_cost,
                                                  rel=1e-9)


def test_device_loop_without_the_rho_pair():
    """An engine that offers no one-pass decrease gets two residual
    passes per attempt and the same trajectory."""
    ba = tsyn.CONFIGS["rs_video_linear"](scale=0.05, seed=0, device="cpu")
    opts = SolverOptions(max_iterations=6)
    _, s_pair = solve(ba.problem, ba.params0, opts)
    fns = make_solver_fns(ba.problem, opts)
    del fns["raw"]["cost_decrease_pair"], fns["raw"]["rho_slots"]
    _, s = solve(ba.problem, ba.params0, opts, fns=fns)
    assert [i.accepted for i in s.iterations] == [
        i.accepted for i in s_pair.iterations]
    assert s.final_cost == pytest.approx(s_pair.final_cost, rel=1e-12)


def test_device_loop_respects_max_iterations():
    ba = tsyn.CONFIGS["rs_video_linear"](scale=0.05, seed=0, device="cpu")
    opts = SolverOptions(max_iterations=3, function_tolerance=0.0,
                         gradient_tolerance=0.0, parameter_tolerance=0.0)
    _, s = solve(ba.problem, ba.params0, opts)
    assert s.termination == "NO_CONVERGENCE"
    assert s.message == "max iterations reached"
    assert s.num_successful_steps + s.num_unsuccessful_steps <= 12
    assert sum(it.accepted for it in s.iterations) <= 3


def test_summary_argument_continues_a_history():
    ba = tsyn.CONFIGS["rs_video_linear"](scale=0.05, seed=0, device="cpu")
    opts = SolverOptions(max_iterations=2, function_tolerance=0.0,
                         gradient_tolerance=0.0, parameter_tolerance=0.0)
    p1, s = solve(ba.problem, ba.params0, opts)
    n1, cost0 = s.num_iterations, s.initial_cost
    _, s2 = solve(ba.problem, p1, opts, summary=s)
    assert s2 is s and s.num_iterations > n1
    assert s.initial_cost == cost0
    assert [it.iteration for it in s.iterations] == list(
        range(s.num_iterations))


def test_termination_codes_match_the_reference():
    from rsba_tpu.solver import lm_device as jdev
    assert lm_device._TERMINATIONS == jdev._TERMINATIONS
    assert lm_device.N_REC == jdev.N_REC
    for name in dir(jdev):
        if name.startswith("TERM_"):
            assert getattr(lm_device, name) == getattr(jdev, name)


# --- pcg ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def band_system():
    """(S dense, M⁻¹ dense, b) of the first solve step of the tiny
    flagship: the band (block rows and their neighbours) and the 6×6
    inverses ``solve_step`` hands to PCG, made dense."""
    fl = __graft_entry__._tiny_flagship(jnp.float64)
    problem, params0 = _port(fl)
    fns = make_solver_fns(problem, SolverOptions())
    aux = fns["prepare"](fns["to_internal"](params0))
    seen = {}
    real = band_pcg.band_pcg

    def spy(rows, nbr, Minv, b, max_iterations, eta):
        seen.update(rows=rows, nbr=nbr, Minv=Minv, b=b)
        return real(rows, nbr, Minv, b, max_iterations, eta)

    band_pcg.band_pcg = spy
    try:
        fns["solve_step"](aux, 1e4)
    finally:
        band_pcg.band_pcg = real
    rows, nbr = seen["rows"], seen["nbr"]
    P = rows.shape[0]
    eye = torch.eye(seen["b"].numel(), dtype=torch.float64)
    S = torch.stack([torch.bmm(rows, e.reshape(P, 6)[nbr].reshape(P, -1, 1))
                     .reshape(-1) for e in eye], dim=1)
    return S, torch.block_diag(*seen["Minv"]), seen["b"]


@pytest.mark.parametrize("max_iterations,eta", [(100, 1e-2), (100, 1e-8),
                                                (5, 1e-12)],
                         ids=["stops_early", "tight", "hits_the_cap"])
def test_pcg_reads_nothing_back_and_matches_reference(
        band_system, monkeypatch, max_iterations, eta):
    S, Minv, b = band_system
    Sj, Mj, bj = (jnp.asarray(x.numpy()) for x in (S, Minv, b))
    xj, rj, kj = jpcg.pcg(lambda p: Sj @ p, lambda r: Mj @ r, bj,
                          max_iterations, eta)

    def no_read(*a, **k):
        raise AssertionError("pcg read a tensor back to the host")

    with monkeypatch.context() as m:
        for name in ("__float__", "__bool__", "__int__", "__index__",
                     "item", "tolist", "numpy", "cpu"):
            m.setattr(torch.Tensor, name, no_read)
        x, r, k = tpcg.pcg(lambda p: S @ p, lambda v: Minv @ v, b,
                           max_iterations, eta)
    assert isinstance(k, torch.Tensor) and k.dtype == torch.int32
    assert int(k) == int(kj)
    if max_iterations == 5:
        assert int(k) == 5
    else:
        assert 0 < int(k) < max_iterations
    scale = float(np.abs(np.asarray(xj)).max())
    # Two float64 loops over the same dense operator; many iterations on
    # an ill-conditioned S amplify round-off to ~1e-7 of an entry.
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-6,
                               atol=1e-8 * scale)
    np.testing.assert_allclose(r.numpy(), np.asarray(rj), rtol=1e-6,
                               atol=1e-9 * float(np.abs(np.asarray(bj)).max()))


def test_pcg_freezes_on_an_indefinite_operator():
    """pᵀq ≤ 0 freezes α at 0 and ends the loop after that pass."""
    A = torch.diag(torch.tensor([1.0, -1.0, 2.0], dtype=torch.float64))
    b = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float64)
    x, r, k = tpcg.pcg(lambda p: A @ p, lambda v: v, b, 50, 1e-6)
    xj, rj, kj = jpcg.pcg(lambda p: jnp.asarray(A.numpy()) @ p, lambda v: v,
                          jnp.asarray(b.numpy()), 50, 1e-6)
    assert int(k) == int(kj) == 1
    np.testing.assert_allclose(x.numpy(), np.asarray(xj))
    np.testing.assert_allclose(r.numpy(), np.asarray(rj))
