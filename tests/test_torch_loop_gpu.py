"""The on-device LM loop replayed from CUDA graphs against the same loop
run eagerly, on the card (``gpu`` marker; skipped without one).

Float64, tiny problems: the captured loop must write the same record
table as the eager one (same accept sequence and CG counts, costs at rel
1e-12), read back one tensor per attempt and block, count a kernel launch
for every prepare, and reuse its graphs on a second solve.  Kept engines
(``lm_device.engines``) capture once for each structure, into one memory
pool, and leave nothing allocated behind a capture.  The file imports
neither jax nor rsba_tpu (from the repo root):

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


# --- engines kept across solves (lm_device.engines) --------------------------

def _frame(rng, m):
    """``m`` 2D-3D matches of a camera at the origin, 0.5 px noise."""
    pts = rng.uniform([-2.0, -2.0, 4.0], [2.0, 2.0, 8.0], (m, 3))
    uv = 512.0 + 900.0 * pts[:, :2] / pts[:, 2:]
    return pts, uv + rng.normal(0.0, 0.5, uv.shape), uv[:, 1]


@pytest.fixture
def captures(monkeypatch):
    """Each capture's ``torch.cuda.memory_allocated`` before its warm-up
    and after its graphs, with the runner."""
    seen = []
    inner = lm_device._Runner._capture

    def counting(self):
        before = torch.cuda.memory_allocated()
        inner(self)
        torch.cuda.synchronize()
        seen.append((before, torch.cuda.memory_allocated(), self))
    monkeypatch.setattr(lm_device._Runner, "_capture", counting)
    lm_device.engines.clear()
    yield seen
    lm_device.engines.clear()


@pytest.mark.gpu
def test_registrations_of_one_padded_count_capture_once(captures):
    """Two frames whose match counts pad to the same multiple of 32: one
    capture, and the second pose is a fresh capture's, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    import numpy as np

    from rsba_tpu_torch.geometry import CameraModel
    from rsba_tpu_torch.solver import pnp
    rng = np.random.default_rng(5)
    model = CameraModel(rolling_shutter=True, rotation_interp="nlerp",
                        use_distortion=False)
    intr = np.array([900.0, 900.0, 512.0, 512.0, 0, 0, 0, 0, 0])
    q0, c0 = np.array([1.0, 0, 0, 0]), np.array([0.02, -0.01, 0.03])
    a, b = _frame(rng, 1000), _frame(rng, 1010)       # both pad to 1024

    def register(frame):
        out = pnp.register_frame(*frame, intr, model, q0, c0,
                                 image_height=1024, dtype=torch.float32)
        torch.cuda.synchronize()
        return out

    fresh = register(b)
    assert len(captures) == 1
    lm_device.engines.clear()
    register(a)
    again = register(b)
    assert len(captures) == 2                  # the fresh one, then A only
    assert fresh[4].termination == again[4].termination
    for x, y in zip(again[:4], fresh[:4]):
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_kept_runners_share_one_pool_and_capture_no_lasting_memory(
        captures):
    """A capture leaves ``memory_allocated`` where it was before its
    warm-up (the runner's state comes first), and every kept runner
    captures into one pool: a runner captured later does not disturb the
    replays of an earlier one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    ba = synthetic.make_ba_problem(dtype=torch.float64, device="cuda",
                                   **chip_smoke.fixtures()["gs_distortion"])
    first = SolverOptions(linear_solver="dense_schur", max_iterations=30)
    second = SolverOptions(linear_solver="iterative_schur",
                           max_iterations=30)
    x1, s1 = solve(ba.problem, ba.params0, first)
    solve(ba.problem, ba.params0, second)
    again, s_again = solve(ba.problem, ba.params0, first)     # a replay
    torch.cuda.synchronize()
    assert len(captures) == 2
    (_, _, r1), (before, after, r2) = captures
    assert r1.pool is not None and r1.pool == r2.pool
    assert after == before
    assert s_again.termination == s1.termination == "CONVERGENCE"
    for x, y in zip(lm_device._leaves(again), lm_device._leaves(x1)):
        assert torch.equal(x, y)
