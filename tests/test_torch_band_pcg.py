"""The band PCG's plain version, launch plans and dispatch, on the CPU.

``kernels/band_pcg.py::band_pcg_reference`` against the generic
``solver/pcg.py::pcg`` over ``make_band_matvec`` /
``make_band_preconditioner`` in float64 (x and r at 1e-12 relative, equal
pass counts) on tiny bands: converging, capped by ``max_iterations``,
indefinite, and narrower than the band; ``banded_fused.solve_step``
(which now hands block-Jacobi PCG to ``band_pcg``) against the same step
through the generic ``pcg``; the kernel's launch plans from shapes alone.
The kernel itself is checked on a card (tests/test_torch_band_pcg_gpu.py).
"""
import numpy as np
import pytest
import torch

import chip_smoke
from rsba_tpu_torch.kernels import band_pcg
from rsba_tpu_torch.problem import synthetic
from rsba_tpu_torch.solver import (SolverOptions, banded, banded_fused,
                                   make_solver_fns)
from rsba_tpu_torch.solver.pcg import pcg

torch.set_num_threads(2)

# name: (P, W, shift of the band's spectrum, sign, max_iterations, eta)
CASES = {
    "converges": (40, 5, 0.05, 1.0, 100, 1e-2),
    "capped": (40, 5, 0.01, 1.0, 7, 1e-2),
    "tight_eta": (30, 4, 0.01, 1.0, 100, 1e-10),
    "indefinite": (60, 6, -0.01, 1.0, 100, 1e-2),
    "negated": (20, 3, 0.05, -1.0, 100, 1e-2),
    "fewer_poses_than_band": (3, 5, 0.05, 1.0, 100, 1e-2),
    "one_pose": (1, 1, 0.05, 1.0, 100, 1e-2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_reference_matches_generic_pcg(case):
    P, W, shift, sign, max_it, eta = CASES[case]
    S = sign * chip_smoke.spd_band(P, W, 3, torch.float64, "cpu", shift)
    b = torch.from_numpy(np.random.default_rng(4).standard_normal(6 * P))
    x, r, k = band_pcg.band_pcg_reference(*chip_smoke.band_inputs(S), b,
                                          max_it, eta)
    xg, rg, kg = pcg(banded.make_band_matvec(S),
                     banded.make_band_preconditioner(S, "schur_jacobi"), b,
                     max_it, eta)
    assert k.dtype == torch.int32 and k.shape == ()
    assert int(k) == int(kg)
    for got, want in ((x, xg), (r, rg)):
        torch.testing.assert_close(got, want, rtol=1e-12,
                                   atol=1e-12 * float(want.abs().max()))
    if case == "capped":
        assert int(k) == max_it
    if case in ("indefinite", "negated"):   # frozen by pᵀq ≤ 0 or rᵀz ≤ 0
        assert 0 < int(k) < max_it and float(r.norm()) > eta * float(b.norm())
    if case == "negated":
        assert int(k) == 1 and not x.any() and torch.equal(r, b)


def test_dispatch_keeps_cpu_tensors_off_the_kernel():
    S = chip_smoke.spd_band(8, 3, 5, torch.float64, "cpu")
    b = torch.ones(48, dtype=torch.float64)
    inp = chip_smoke.band_inputs(S)
    before = band_pcg.band_pcg_cuda.launches
    got = band_pcg.band_pcg(*inp, b, 100, 1e-2)
    want = band_pcg.band_pcg_reference(*inp, b, 100, 1e-2)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        band_pcg.band_pcg_cuda(*inp, b, 100, 1e-2)
    assert band_pcg.band_pcg_cuda.launches == before


# (P, W, itemsize): (CTAs, poses a CTA, rows in shared memory) of the first
# plan; config 4 in float32 and float64, config 3, config 5 in float64 and
# float32, a tiny band
PLANS = {(1001, 11, 4): (16, 63, True), (1001, 11, 8): (16, 63, False),
         (201, 13, 4): (16, 13, True), (10001, 9, 8): (16, 626, False),
         (10001, 9, 4): (16, 626, False), (5, 3, 8): (5, 1, True)}


@pytest.mark.parametrize("shape", list(PLANS), ids=str)
def test_launch_plans_fit_shared_memory(shape):
    P, W, itemsize = shape
    plans = band_pcg.launch_plans(P, W, itemsize)
    first = plans[0]
    assert (first.ctas, first.poses_per_cta, first.rows_in_smem) \
        == PLANS[shape]
    for plan in plans:
        assert plan.ctas <= 16
        assert (plan.ctas - 1) * plan.poses_per_cta < P \
            <= plan.ctas * plan.poses_per_cta
        assert plan.smem_bytes <= band_pcg.SMEM_BLOCK
        assert plan.smem_bytes == band_pcg.smem_bytes(
            plan.poses_per_cta, W, itemsize, plan.rows_in_smem)


def test_launch_plans_refuse_a_band_too_large():
    with pytest.raises(ValueError, match="shared memory"):
        band_pcg.launch_plans(100_000, 11, 8)


def test_solve_step_matches_the_generic_pcg_step(monkeypatch):
    """The step through ``band_pcg`` equals the step through the generic
    ``pcg`` over the band's operators, on the same reduced system."""
    ba = synthetic.make_ba_problem(dtype=torch.float64, device="cpu",
                                   **chip_smoke.fixtures()["rs_nlerp"])
    opts = SolverOptions()
    fns = make_solver_fns(ba.problem, opts)
    plan = fns["raw"]["bound"][0]
    aux = fns["prepare"](fns["to_internal"](ba.params0))
    new = banded_fused.solve_step(plan, opts, aux, 1e4)

    real = banded_fused.reduced_system
    seen = {}

    def recorded(*args, **kw):
        seen["S"] = real(*args, **kw)[0]
        return real(*args, **kw)

    def generic(rows, nbr, Minv, b, max_it, eta):
        S = seen["S"]
        return pcg(banded.make_band_matvec(S),
                   banded.make_band_preconditioner(S, "schur_jacobi"), b,
                   max_it, eta)

    monkeypatch.setattr(banded_fused, "reduced_system", recorded)
    monkeypatch.setattr(band_pcg, "band_pcg", generic)
    old = banded_fused.solve_step(plan, opts, aux, 1e4)

    assert int(new[2]) == int(old[2]) > 0
    assert torch.equal(new[1], old[1])
    for k in ("pose", "pt"):
        assert torch.equal(new[0][k], old[0][k])
