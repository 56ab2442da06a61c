"""Flat engines kept across solves (``rsba_tpu_torch/solver/lm_device.py``,
``engines``), on the CPU, where the runner runs eagerly and the cache
still rebinds: a later problem of the same structure reuses the engine
with its own data copied in.

A solve through a hit equals a fresh solve bit for bit; equal shapes
with other index tensors miss; the caller's tensors stay as they were;
the cache keeps at most ``ENGINE_CACHE_SIZE`` engines; engines that are
not rebindable, and calls with their own ``fns``, bypass it; traced and
untraced solves take separate entries.  The file imports neither jax nor
rsba_tpu (from the repo root):

    python -m pytest --noconftest -o addopts= tests/test_torch_engine_cache.py
"""
import gc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rsba_tpu_torch.geometry import CameraModel
from rsba_tpu_torch.problem import synthetic
from rsba_tpu_torch.problem.types import Problem, intr_basis_bal
from rsba_tpu_torch.solver import (SolverOptions, lm, lm_device,
                                   make_solver_fns, pnp, solve)
from rsba_tpu_torch.utils import trace

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def empty_cache():
    lm_device.engines.clear()
    yield
    lm_device.engines.clear()


@pytest.fixture
def makes(monkeypatch):
    """The engines built through ``lm.make_solver_fns``, in order."""
    built = []

    def counting(problem, options):
        built.append(options.linear_solver)
        return make_solver_fns(problem, options)
    monkeypatch.setattr(lm, "make_solver_fns", counting)
    return built


def _tiny(dtype=torch.float64, seed=1):
    return synthetic.CONFIGS["gs_small"](scale=0.1, seed=seed, dtype=dtype,
                                         device="cpu")


def _other_data(ba, seed=7):
    """A problem and a start with ``ba``'s index tensors and other data:
    pixels moved, 5% of the observations masked out, pose 1 held."""
    g = torch.Generator().manual_seed(seed)
    problem, obs = ba.problem, ba.problem.obs
    dt = obs.uv.dtype
    uv = obs.uv + 0.3 * torch.randn(obs.uv.shape, generator=g).to(dt)
    mask = obs.mask * (torch.rand(obs.mask.shape, generator=g) > 0.05).to(dt)
    pose_free = problem.pose_free.clone()
    pose_free[1] = 0.0
    problem = problem.replace(obs=obs.replace(uv=uv, mask=mask),
                              pose_free=pose_free)
    points = ba.params0.points + 0.01 * torch.randn(
        ba.params0.points.shape, generator=g).to(dt)
    return problem, ba.params0.replace(points=points)


def _fields(x) -> list:
    """The tensors of a Problem or Params, in a fixed order."""
    if isinstance(x, Problem):
        return lm_device._data(x) + lm_device._indices(x)
    return lm_device._leaves(x)


def _traced_solve(problem, params, options, **kw):
    """``solve`` under a CPU profiler: (summary, the solve span's
    ``engine_cache``)."""
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        _, s = solve(problem, params, options, **kw)
    root = [r for r in trace.records() if r["name"] == "solve"][-1]
    trace.clear()
    return s, root["attrs"]["engine_cache"]


CASES = [("dense_schur", torch.float64), ("dense_schur", torch.float32),
         ("iterative_schur", torch.float64),
         ("iterative_schur", torch.float32), ("auto", torch.float32)]


@pytest.mark.parametrize("solver,dtype", CASES,
                         ids=[f"{s}-{str(d)[6:]}" for s, d in CASES])
def test_a_hit_equals_a_fresh_solve_bit_for_bit(solver, dtype, makes):
    """``auto`` with the focal and k1, k2 free (self-calibration): the
    shapes rule the window layout out, so it is ``iterative_schur``."""
    ba = _tiny(dtype)
    if solver == "auto":
        ba.problem = ba.problem.replace(intr_basis=torch.as_tensor(
            intr_basis_bal(), dtype=dtype))
    problem_b, start_b = _other_data(ba)
    opts = SolverOptions(linear_solver=solver, max_iterations=30)
    fresh, s_fresh = solve(problem_b, start_b, opts,
                           fns=make_solver_fns(problem_b, opts))
    solve(ba.problem, ba.params0, opts)
    assert makes == [solver] and len(lm_device.engines) == 1
    hit, s_hit = solve(problem_b, start_b, opts)
    assert makes == [solver]                 # nothing built again
    for a, b in zip(_fields(hit), _fields(fresh)):
        assert torch.equal(a, b)
    assert s_hit.linear_solver == s_fresh.linear_solver != "banded_schur"
    assert s_hit.termination == s_fresh.termination
    assert s_hit.final_cost == s_fresh.final_cost
    assert s_hit.num_residuals == s_fresh.num_residuals
    assert ([(i.cost, i.trust_region_radius, i.linear_solver_iterations)
             for i in s_hit.iterations]
            == [(i.cost, i.trust_region_radius, i.linear_solver_iterations)
                for i in s_fresh.iterations])


def test_registrations_of_one_padded_count_share_an_engine(makes):
    """Two frames whose correspondence counts pad to the same multiple of
    32 reuse one engine, and the second pose is the one a fresh engine
    gives."""
    rng = np.random.default_rng(3)
    model = CameraModel(rolling_shutter=True, rotation_interp="nlerp",
                        use_distortion=False)
    intr = np.array([900.0, 900.0, 512.0, 384.0, 0, 0, 0, 0, 0])

    def frame(m):
        pts = rng.uniform([-2, -2, 4], [2, 2, 8], (m, 3))
        uv = intr[2:4] + 900.0 * pts[:, :2] / pts[:, 2:]
        uv = uv + rng.normal(0.0, 0.5, uv.shape)
        return pts, uv, uv[:, 1]

    q0, c0 = np.array([1.0, 0, 0, 0]), np.array([0.02, -0.01, 0.03])
    a, b = frame(100), frame(110)                  # both pad to 128
    kw = dict(image_height=768, dtype=torch.float32, device="cpu")
    fresh = pnp.register_frame(*b, intr, model, q0, c0, **kw)
    lm_device.engines.clear()
    pnp.register_frame(*a, intr, model, q0, c0, **kw)
    again = pnp.register_frame(*b, intr, model, q0, c0, **kw)
    assert makes == ["dense_schur", "dense_schur"]     # the fresh one, A
    assert len(lm_device.engines) == 1
    for x, y in zip(again[:4], fresh[:4]):
        assert torch.equal(x, y)


def test_equal_shapes_with_other_indices_miss(makes):
    ba = _tiny()
    obs = ba.problem.obs
    n = int(obs.mask.sum())
    point = obs.point.clone()
    point[:n] = torch.flip(point[:n], (0,))       # same shapes, new tracks
    other = ba.problem.replace(obs=obs.replace(point=point))
    opts = SolverOptions(linear_solver="dense_schur", max_iterations=10)
    solve(ba.problem, ba.params0, opts)
    solve(other, ba.params0, opts)
    assert len(makes) == 2
    assert len(lm_device.engines) == 1            # it took the key's place
    solve(other, ba.params0, opts)
    assert len(makes) == 2


def test_a_hit_leaves_the_callers_tensors_unchanged():
    ba = _tiny()
    problem_b, start_b = _other_data(ba)
    opts = SolverOptions(linear_solver="iterative_schur", max_iterations=10)
    before = [t.clone() for t in _fields(ba.problem) + _fields(ba.params0)
              + _fields(problem_b) + _fields(start_b)]
    x_a, _ = solve(ba.problem, ba.params0, opts)
    kept = [t.clone() for t in _fields(x_a)]
    x_b, _ = solve(problem_b, start_b, opts)
    after = (_fields(ba.problem) + _fields(ba.params0) + _fields(problem_b)
             + _fields(start_b))
    assert all(torch.equal(a, b) for a, b in zip(after, before))
    # each solve's result is its own: the next solve writes none of it
    assert all(torch.equal(a, b) for a, b in zip(_fields(x_a), kept))
    assert all(a.data_ptr() != b.data_ptr()
               for a, b in zip(_fields(x_a), _fields(x_b)))


def test_the_cache_keeps_at_most_its_size(makes):
    """Ten structures (the options are part of the key): never more than
    ``ENGINE_CACHE_SIZE`` entries, the least recently used out first."""
    assert lm_device.ENGINE_CACHE_SIZE == 8
    ba = _tiny()
    opts = [SolverOptions(linear_solver="dense_schur", max_iterations=k)
            for k in range(1, 11)]
    for o in opts:
        solve(ba.problem, ba.params0, o)
        assert len(lm_device.engines) <= lm_device.ENGINE_CACHE_SIZE
    assert len(lm_device.engines) == 8 and len(makes) == 10
    solve(ba.problem, ba.params0, opts[-1])       # kept: a hit
    assert len(makes) == 10
    solve(ba.problem, ba.params0, opts[0])        # evicted: built again
    assert len(makes) == 11 and len(lm_device.engines) == 8


BYPASS = {
    "banded": (dict(linear_solver="auto"), False),
    "dogleg": (dict(linear_solver="dense_schur",
                    trust_region_strategy="dogleg"), False),
    "host_loop": (dict(linear_solver="dense_schur", device_loop="off"),
                  False),
    "own_fns": (dict(linear_solver="dense_schur"), True),
}


@pytest.mark.parametrize("case", list(BYPASS))
def test_engines_that_do_not_rebind_bypass_the_cache(case):
    kw, own_fns = BYPASS[case]
    if case == "banded":
        ba = synthetic.CONFIGS["rs_video_linear"](scale=0.05, seed=0,
                                                  device="cpu")
    else:
        ba = _tiny()
    opts = SolverOptions(max_iterations=10, **kw)
    assert lm.rebindable(ba.problem, opts) == (case == "own_fns")
    fns = make_solver_fns(ba.problem, opts) if own_fns else None
    s, cached = _traced_solve(ba.problem, ba.params0, opts, fns=fns)
    assert cached == "bypass"
    assert len(lm_device.engines) == 0
    if case == "banded":
        assert s.linear_solver == "banded_schur"


def test_traced_and_untraced_solves_take_separate_entries(makes):
    ba = _tiny()
    opts = SolverOptions(linear_solver="dense_schur", max_iterations=10)
    solve(ba.problem, ba.params0, opts)
    assert len(lm_device.engines) == 1
    _, first = _traced_solve(ba.problem, ba.params0, opts)
    _, second = _traced_solve(ba.problem, ba.params0, opts)
    assert (first, second) == ("miss", "hit")
    assert len(lm_device.engines) == 2
    solve(ba.problem, ba.params0, opts)
    assert len(makes) == 2 and len(lm_device.engines) == 2


@pytest.mark.gpu
def test_a_capture_after_clear_takes_a_new_graph_pool():
    """Once ``clear`` has dropped every kept runner, their graph pool dies
    with them: the next solve captures into a new pool (a capture into
    the old handle fails inside the caching allocator)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    ba = synthetic.CONFIGS["gs_small"](scale=0.1, seed=1,
                                       dtype=torch.float32, device="cuda")
    opts = SolverOptions(linear_solver="dense_schur", max_iterations=10)
    for _ in range(2):
        _, s = solve(ba.problem, ba.params0, opts)
        assert s.evaluator == "torch-flat+device_loop"
        assert s.num_iterations > 0 and len(lm_device.engines) == 1
        lm_device.engines.clear()
        gc.collect()
        torch.cuda.empty_cache()
