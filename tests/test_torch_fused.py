"""Fused evaluate+assemble and the banded solve step: port vs reference.

The plain PyTorch version of the fused kernel
(``kernels.fused.fused_evaluate_assemble_reference``), folded and unscaled
by ``banded_fused.prepare``, must reproduce ``rsba_tpu.solver.banded``'s
evaluate + assemble — the plain reference that tests/test_fused_kernel.py
ties to the interpret-mode Pallas kernel — at rtol/atol 1e-9 (cost
1e-12), on the three fixtures of test_fused_kernel.py and on
``__graft_entry__._tiny_flagship``.  The port's planes-layout solve step
must match the reference window engine's at rtol 1e-6 on dx and 1e-8 on
the predicted decrease.  The CUDA kernel itself is checked against the
plain version on a card, in tests/test_torch_kernel_gpu.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from rsba_tpu.problem import synthetic as jsyn
from rsba_tpu.solver import banded as jbanded
from rsba_tpu.solver import banded_tpu as jbanded_tpu
from rsba_tpu.solver import window as jwindow
from rsba_tpu.solver.options import SolverOptions as JOptions
from rsba_tpu_torch.kernels import fused
from rsba_tpu_torch.problem import types as ttypes
from rsba_tpu_torch.solver import SolverOptions, banded_fused, solve
from rsba_tpu_torch.solver import window as twindow

# As in test_fused_kernel.py: raw (unscaled) assembly is directly
# comparable; a tight CG makes the step comparison about the algebra.
OPTS = dict(jacobi_scaling=False, max_cg_iterations=120, cg_eta=1e-12,
            max_iterations=15, function_tolerance=1e-5)


def _fixture(name):
    if name == "rs_slerp":
        return jsyn.make_ba_problem(
            n_poses=9, n_points=80, track_len=3, rolling_shutter=True,
            rotation_interp="slerp", use_distortion=False,
            loss=jsyn.Loss("huber", 4.0), pixel_noise=0.5, seed=3,
            dtype=jnp.float64, pad_to=32)
    if name == "rs_nlerp":
        return jsyn.make_ba_problem(
            n_poses=9, n_points=64, track_len=3, rolling_shutter=True,
            rotation_interp="nlerp", use_distortion=False,
            pixel_noise=0.5, seed=5, dtype=jnp.float64, pad_to=32)
    if name == "gs":
        return jsyn.make_ba_problem(
            n_poses=9, n_points=64, track_len=3, rolling_shutter=False,
            use_distortion=True, pixel_noise=0.5, seed=4,
            dtype=jnp.float64, pad_to=32)
    return __graft_entry__._tiny_flagship(jnp.float64)


class Case:
    """One fixture in both packages, with the engines built once."""

    def __init__(self, name):
        self.name = name
        self.ba = _fixture(name)
        self.jplan = jwindow.build_window_plan(self.ba.problem)
        self.problem = ttypes.problem_from_numpy(self.ba.problem,
                                                 device="cpu")
        self.params0 = ttypes.params_from_numpy(self.ba.params0,
                                                device="cpu")
        self.plan = twindow.build_window_plan(self.problem)
        self.statics = banded_fused.kernel_statics(self.plan, self.problem)
        self.params = banded_fused.to_internal(self.params0, self.plan)

    def kernel_inputs(self):
        return banded_fused.kernel_inputs(self.params, self.plan,
                                          self.problem, self.statics)

    def prepare(self, **kw):
        return banded_fused.prepare(
            self.plan, self.problem, SolverOptions(**kw), self.params,
            fused.fused_evaluate_assemble_reference, self.statics)


@pytest.fixture(scope="module",
                params=["rs_slerp", "rs_nlerp", "gs", "flagship"])
def case(request):
    return Case(request.param)


@pytest.fixture(scope="module")
def ref_assembly(case):
    """rsba_tpu.solver.banded evaluate + assemble (jitted, f64)."""
    @jax.jit
    def run(params, plan, problem):
        p = jbanded.to_internal(params, plan)
        ev = jbanded.evaluate(p, plan, problem)
        return ev.cost, jbanded.assemble(ev, plan)

    return run(case.ba.params0, case.jplan, case.ba.problem)


def _close(got, want, **kw):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want),
                               **kw)


def test_plain_kernel_matches_reference_assembly(case, ref_assembly):
    cost, a = ref_assembly
    aux = case.prepare(jacobi_scaling=False)
    plan = case.plan
    _close(aux["cost"], cost, rtol=1e-12)
    _close(aux["g_cam"], a.g_cam, rtol=1e-9, atol=1e-9)
    _close(aux["B0"], a.B_band[:, 0], rtol=1e-9, atol=1e-9)
    if plan.W > 1:
        _close(aux["B1"], a.B_band[:, 1], rtol=1e-9, atol=1e-9)
    _close(aux["g_pt"].transpose(1, 2), a.g_pt, rtol=1e-9, atol=1e-9)
    C_full = banded_fused._sym_full(aux["c6"])       # (NR, 3, 3, G)
    _close(C_full.permute(0, 3, 1, 2), a.C, rtol=1e-9, atol=1e-9)
    F5 = aux["F"].reshape(plan.NR, plan.W, 6, 3, plan.G)
    _close(F5.permute(0, 4, 1, 2, 3), a.F, rtol=1e-9, atol=1e-9)


def test_solve_step_matches_reference(case):
    """Prepare + damped Schur solve vs the reference window engine; with
    Jacobi scaling on as well for the flagship (B1's columns take the
    next pose's scale)."""
    for scaling in (False, True) if case.name == "flagship" else (False,):
        opts = dict(OPTS, jacobi_scaling=scaling)
        fns_w = jbanded.make_window_solver_fns(
            case.ba.problem, case.jplan, JOptions(**opts))
        aux_w = fns_w["prepare"](fns_w["to_internal"](case.ba.params0))
        dx_w, pred_w, _ = fns_w["solve_step"](
            aux_w, jnp.asarray(1e4, jnp.float64))

        aux = case.prepare(**opts)
        _close(aux["cost"], aux_w["cost"], rtol=1e-12)
        _close(aux["gradient_max_norm"], aux_w["gradient_max_norm"],
               rtol=1e-9)
        dx, pred, _ = banded_fused.solve_step(
            case.plan, SolverOptions(**opts), aux, 1e4)
        _close(dx["pose"], dx_w["pose"], rtol=1e-6, atol=1e-12)
        _close(dx["pt"].transpose(1, 2).reshape(-1, 3),
               np.asarray(dx_w["pt"]).reshape(-1, 3), rtol=1e-6, atol=1e-12)
        _close(pred, pred_w, rtol=1e-8)


def test_dispatch_uses_plain_version_on_cpu(case):
    before = fused.fused_evaluate_assemble_cuda.launches
    inp = case.kernel_inputs()
    model, loss = case.problem.model, case.problem.loss
    out = fused.fused_evaluate_assemble(*inp, model=model, loss=loss)
    ref = fused.fused_evaluate_assemble_reference(*inp, model=model,
                                                  loss=loss)
    for k in ref:
        torch.testing.assert_close(out[k], ref[k], rtol=0, atol=0)
    assert fused.fused_evaluate_assemble_cuda.launches == before


def test_cuda_kernel_raises_on_cpu_tensors(case):
    inp = case.kernel_inputs()
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        fused.fused_evaluate_assemble_cuda(*inp, model=case.problem.model,
                                           loss=case.problem.loss)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        solve(case.problem, case.params0,
              SolverOptions(evaluator="cuda", max_iterations=2))


def test_default_device_is_the_card():
    """Without a device the entry points take the card and raise where
    there is none; ``device="cpu"`` asks for the CPU."""
    import rsba_tpu_torch
    from rsba_tpu_torch.problem import synthetic as tsyn
    assert rsba_tpu_torch.default_device("cpu") == torch.device("cpu")
    ba = _fixture("gs")
    tiny = dict(n_poses=5, n_points=20, track_len=3)
    calls = [lambda **kw: tsyn.make_ba_problem(**tiny, **kw),
             lambda **kw: ttypes.params_from_numpy(ba.params0, **kw),
             lambda **kw: ttypes.problem_from_numpy(ba.problem, **kw)]
    calls += [lambda f=f, **kw: f(scale=0.001, **kw)
              for f in tsyn.CONFIGS.values()]
    assert len(calls) == 8
    if torch.cuda.is_available():
        assert rsba_tpu_torch.default_device().type == "cuda"
        assert calls[0]().problem.device.type == "cuda"
        assert calls[1]().device.type == "cuda"
        assert calls[2]().device.type == "cuda"
    else:
        for call in calls:
            with pytest.raises(RuntimeError, match='device="cpu"'):
                call()
    assert calls[0](device="cpu").problem.device.type == "cpu"
    assert calls[1](device="cpu").device.type == "cpu"
    assert calls[2](device="cpu").device.type == "cpu"


# (W, G, itemsize, rolling shutter) -> (threads, tile columns, chunks)
LAUNCH_PLANS = [
    ((11, 112, 4, True), (128, 112, 1)),    # config 4: the whole row
    ((11, 112, 8, True), (128, 112, 1)),
    ((4, 24, 8, True), (32, 24, 1)),
    ((5, 40, 8, True), (64, 40, 1)),
    ((3, 16, 8, False), (32, 16, 1)),
    ((5, 352, 8, True), (128, 128, 3)),     # wider than a block: chunks
    ((24, 1024, 4, True), (96, 96, 11)),    # widest window: narrower tile
    ((24, 1024, 8, True), (32, 32, 32)),
]


@pytest.mark.parametrize("shape,want", LAUNCH_PLANS)
def test_launch_plan_routes(shape, want):
    W, G, itemsize, rs = shape
    plan = fused.launch_plan(W, G, itemsize, rs)
    assert (plan.threads, plan.tile_cols, plan.chunks) == want
    assert plan.threads % 32 == 0 and plan.threads <= fused.MAX_THREADS
    assert plan.tile_cols == min(plan.threads, G)
    assert plan.chunks * plan.threads >= G > (plan.chunks - 1) * plan.threads
    assert plan.smem_bytes == fused.smem_bytes(W, plan.threads,
                                               plan.tile_cols, itemsize, rs)
    assert plan.smem_bytes <= fused.SMEM_BLOCK
    assert plan.blocks_per_sm >= 1


def test_launch_plan_and_wrapper_raise_on_shapes_they_cannot_take(case):
    with pytest.raises(ValueError, match="does not fit"):
        fused.launch_plan(80, 112, 8, True)
    inp = list(case.kernel_inputs())
    model, loss = case.problem.model, case.problem.loss
    wide = [x.repeat_interleave(fused.MAX_G // case.plan.G + 1, dim=-1)
            if i in (1, 2, 3, 4, 5, 6, 7) else x for i, x in enumerate(inp)]
    with pytest.raises(ValueError, match="points per row"):
        fused._run(None, 0, *(x.contiguous() for x in wide), model, loss)
    with pytest.raises(ValueError, match="must be contiguous"):
        fused._run(None, 0, inp[0].transpose(0, 1).contiguous()
                   .transpose(0, 1), *inp[1:], model, loss)


@pytest.mark.slow
def test_plain_kernel_matches_interpret_pallas_prepare():
    """Against the Pallas kernel itself (interpret mode, exact atan)."""
    c = Case("rs_slerp")
    jopts = JOptions(jacobi_scaling=True)
    p = jbanded_tpu.to_internal(c.ba.params0, c.jplan)
    want = jbanded_tpu.prepare(c.jplan, c.ba.problem, jopts, p,
                               interpret=True)
    got = c.prepare(jacobi_scaling=True)
    _close(got["cost"], want["cost"], rtol=1e-12)
    for k in ("g_cam", "B0", "B1", "g_pt", "c6", "F", "s_cam", "s_pt"):
        _close(got[k], want[k], rtol=1e-9, atol=1e-9)

