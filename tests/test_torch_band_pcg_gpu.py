"""The band PCG kernel (``csrc/band_pcg.cu``) against its plain version on
the card (``gpu`` marker; skipped without one).

Seeded SPD bands at config 4's shape (P = 1001, W = 11), config 3's
(P = 201, W = 13) and config 5's (P = 10,001, W = 9, whose rows do not fit
a CTA's shared memory and stream from global memory on every pass), and
two small ragged ones, in float64 and float32:
float64 at 1e-10 of max|x| and of max|b| with equal pass counts; float32,
whose sums run in another order, at 1e-3 of max|x| and 5e-3 of max|b|,
ten times the plain version's own float32 round-off (it sits up to 2.6e-5
and 5.8e-4 from float64 on these bands), with equal pass counts (‖r‖ ends
at least 8% under η‖b‖ on them).  Two launches give equal bits; an
indefinite band freezes where the plain version does (‖r‖ = −1 ends the
loop above η‖b‖), a negated one after one pass with x = 0 and r = b; a
band capped by ``max_iterations`` matches; and a replay of a captured step
attempt adds its launch to ``band_pcg_cuda.launches``.  The file imports neither jax nor rsba_tpu
(from the repo root):

    python -m pytest --noconftest -o addopts= tests/test_torch_band_pcg_gpu.py
"""
import numpy as np
import pytest
import torch

import chip_smoke
from rsba_tpu_torch.kernels import band_pcg
from rsba_tpu_torch.problem import synthetic
from rsba_tpu_torch.solver import (SolverOptions, lm_device, make_solver_fns,
                                   solve)

# name: (P, W, shift of the band's spectrum)
BANDS = {"config4": (1001, 11, 0.05), "config3": (201, 13, 0.05),
         "ragged": (37, 4, 0.05), "tiny": (5, 3, 0.05),
         "config5": (10001, 9, 0.05)}
TOL = {torch.float64: (1e-10, 1e-10), torch.float32: (1e-3, 5e-3)}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")


def _system(P, W, shift, dtype, sign=1.0, seed=4):
    S = sign * chip_smoke.spd_band(P, W, seed, dtype, "cuda", shift)
    b = torch.from_numpy(np.random.default_rng(seed + 1)
                         .standard_normal(6 * P)).to(dtype=dtype,
                                                     device="cuda")
    return chip_smoke.band_inputs(S), b


def _both(inp, b, max_it=100, eta=1e-2):
    want = band_pcg.band_pcg_reference(*inp, b, max_it, eta)
    got = band_pcg.band_pcg_cuda(*inp, b, max_it, eta)
    torch.cuda.synchronize()
    return got, want


def _close(got, want, b, dtype):
    x_tol, r_tol = TOL[dtype]
    (x, r, k), (xw, rw, kw) = got, want
    assert k.dtype == torch.int32 and k.shape == ()
    assert int(k) == int(kw)
    assert float((x - xw).abs().max()) <= x_tol * float(xw.abs().max())
    assert float((r - rw).abs().max()) <= r_tol * float(b.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("band", list(BANDS))
def test_kernel_matches_plain_version(band, dtype):
    _card()
    P, W, shift = BANDS[band]
    inp, b = _system(P, W, shift, dtype)
    got, want = _both(inp, b)
    _close(got, want, b, dtype)
    assert 0 < int(want[2]) < 100
    if band == "config5":     # the rows stream from global memory
        assert not band_pcg._PLANS[(P, W, dtype, b.device)].rows_in_smem


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_two_launches_give_equal_bits(dtype):
    _card()
    inp, b = _system(*BANDS["config4"], dtype)
    first = band_pcg.band_pcg_cuda(*inp, b, 100, 1e-2)
    second = band_pcg.band_pcg_cuda(*inp, b, 100, 1e-2)
    torch.cuda.synchronize()
    assert all(torch.equal(f, s) for f, s in zip(first, second))


@pytest.mark.gpu
def test_indefinite_band_freezes_where_the_plain_version_does():
    _card()
    inp, b = _system(201, 13, -0.01, torch.float64)
    got, want = _both(inp, b)
    _close(got, want, b, torch.float64)
    assert 0 < int(got[2]) < 100                      # ‖r‖ = −1 ended it
    assert float(got[1].norm()) > 1e-2 * float(b.norm())
    inp, b = _system(201, 13, 0.05, torch.float64, sign=-1.0)
    (x, r, k), want = _both(inp, b)
    assert int(k) == int(want[2]) == 1
    assert not x.any() and torch.equal(r, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_band_capped_by_max_iterations(dtype):
    _card()
    inp, b = _system(*BANDS["config4"], dtype)
    got, want = _both(inp, b, max_it=7, eta=1e-12)
    assert int(got[2]) == 7
    _close(got, want, b, dtype)


@pytest.mark.gpu
def test_graph_replay_counts_its_launch():
    """A banded solve through the captured loop: the capture takes back
    the launch it recorded, and every replay of the attempt's graph adds
    one; a second solve on the same graphs launches once per attempt."""
    _card()
    ba = synthetic.make_ba_problem(
        dtype=torch.float64, device="cuda",
        **chip_smoke.fixtures()["flagship_slerp_dist_huber"])
    opts = SolverOptions(max_iterations=30)
    fns = make_solver_fns(ba.problem, opts)
    solve(ba.problem, ba.params0, opts, fns=fns)
    (runner,) = fns["_device_runners"].values()
    # fused, band PCG, residual pass
    assert runner.kernel_nodes[0] == (0, 1, 1)
    assert runner.kernel_nodes[1] == (1, 0, 0)

    attempts = [0]
    real = lm_device._Runner.attempt

    def counted(self):
        attempts[0] += 1
        return real(self)

    band_pcg.band_pcg_cuda.launches = 0
    with pytest.MonkeyPatch.context() as m:
        m.setattr(lm_device._Runner, "attempt", counted)
        _, s = solve(ba.problem, ba.params0, opts, fns=fns)
    assert s.termination == "CONVERGENCE"
    assert band_pcg.band_pcg_cuda.launches == attempts[0] > 0
