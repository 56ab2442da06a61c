"""The on-device LM loop replayed from CUDA graphs against the same loop
run eagerly, on the card (``gpu`` marker; skipped without one).

Float64, tiny problems: the captured loop must write the same record
table as the eager one (same accept sequence and CG counts, costs at rel
1e-12), read back one tensor per attempt and block, count a kernel launch
for every prepare, and reuse its graphs on a second solve.  The file
imports neither jax nor rsba_tpu (from the repo root):

    python -m pytest --noconftest -o addopts= tests/test_torch_loop_gpu.py
"""
import pytest
import torch

import chip_smoke
from rsba_tpu_torch.kernels import fused
from rsba_tpu_torch.problem import synthetic
from rsba_tpu_torch.solver import (SolverOptions, lm_device, make_solver_fns,
                                   solve)

CASES = {
    "flagship_band": (dict(), "flagship_slerp_dist_huber"),
    "flagship_band_cluster": (dict(preconditioner="cluster_jacobi"),
                              "flagship_slerp_dist_huber"),
    "gs_dense_schur": (dict(linear_solver="dense_schur"), "gs_distortion"),
    "gs_iterative_cluster": (dict(linear_solver="iterative_schur",
                                  preconditioner="cluster_jacobi"),
                             "gs_distortion"),
}


def test_case_fixtures_exist():
    assert {f for _, f in CASES.values()} <= set(chip_smoke.fixtures())


@pytest.mark.gpu
@pytest.mark.parametrize("prepare_in_every_attempt", [False, True],
                         ids=["prepare_on_a_flag", "prepare_every_attempt"])
@pytest.mark.parametrize("case", list(CASES))
def test_captured_loop_matches_eager_loop(case, prepare_in_every_attempt,
                                          monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    option_kw, fixture = CASES[case]
    ba = synthetic.make_ba_problem(dtype=torch.float64, device="cuda",
                                   **chip_smoke.fixtures()[fixture])
    opts = SolverOptions(max_iterations=30, **option_kw)

    with monkeypatch.context() as m:      # the same functions, not captured
        m.setattr(lm_device._Runner, "_capture", lambda self: None)
        _, eager = solve(ba.problem, ba.params0, opts)

    fns = make_solver_fns(ba.problem, opts)
    if prepare_in_every_attempt:
        n = lm_device.block_size(opts, False)
        fns["_device_runners"] = {(n, opts): lm_device.make_device_runner(
            fns["raw"], opts, n, prepare_in_attempt=True)}
    fused.fused_evaluate_assemble_cuda.launches = 0
    _, first = solve(ba.problem, ba.params0, opts, fns=fns)
    (runner,) = fns["_device_runners"].values()
    assert runner.graphs is not None
    assert (runner.graphs[1] is None) == prepare_in_every_attempt
    if fns["engine"][0] == "banded_schur":
        assert (fused.fused_evaluate_assemble_cuda.launches
                == runner.prepares > 0)
    graphs = runner.graphs
    _, second = solve(ba.problem, ba.params0, opts, fns=fns)
    assert runner.graphs is graphs

    for s in (first, second):
        assert s.evaluator.endswith("+device_loop")
        assert s.termination == eager.termination == "CONVERGENCE"
        assert s.message == eager.message
        assert len(s.iterations) == len(eager.iterations)
        for a, b in zip(s.iterations, eager.iterations):
            assert a.accepted == b.accepted
            assert a.linear_solver_iterations == b.linear_solver_iterations
            assert a.cost == pytest.approx(b.cost, rel=1e-12)
            assert a.trust_region_radius == pytest.approx(
                b.trust_region_radius, rel=1e-12)
        assert s.final_cost == pytest.approx(eager.final_cost, rel=1e-12)
        assert 0 < s.host_reads <= eager.host_reads


@pytest.mark.gpu
def test_capture_failure_raises(monkeypatch):
    """A phase that synchronises cannot be captured: the solve raises and
    does not carry on another way."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    ba = synthetic.make_ba_problem(
        dtype=torch.float64, device="cuda",
        **chip_smoke.fixtures()["flagship_slerp_dist_huber"])
    fns = make_solver_fns(ba.problem, SolverOptions())
    inner = fns["raw"]["solve_step"]

    def syncing(bound, aux, radius):
        float(radius)                      # a host read inside the attempt
        return inner(bound, aux, radius)

    fns["raw"]["solve_step"] = syncing
    with pytest.raises(Exception):
        solve(ba.problem, ba.params0, SolverOptions(), fns=fns)
