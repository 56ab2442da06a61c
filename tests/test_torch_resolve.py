"""The ``rs_slerp_robust.resolve`` cell's traffic kind
(``portbench/kinds/solve_resolve.py``), on the CPU at a small config 4.

The held-back problem (its frames, poses, points and observations) and
the warm start of the whole problem; whole runs of the cell, sound, under
each fault and as its bfloat16 control.  The file imports neither jax nor
rsba_tpu (from the repo root):

    python -m pytest --noconftest -o addopts= tests/test_torch_resolve.py
"""
import numpy as np
import pytest
import torch

from portbench import manifest, run
from portbench.kinds import solve_resolve
from portbench.reference import generator
from portbench.tools import faults

torch.set_num_threads(2)
BENCH = manifest.load()
SEED = 2**31 + 97


def _cfg(n_poses=13, n_points=300) -> dict:
    """Config 4 at 12 frames; 20 CG passes an attempt are plenty for its
    72 pose columns and keep the eager CPU loop short, and 25 attempts
    (pool seed 1 converges in 5 held back and 3 whole) keep a faulty
    solve that never converges short too."""
    cfg = manifest.config(BENCH, "rs_slerp_robust")
    cfg["generator"].update(n_poses=n_poses, n_points=n_points)
    cfg["solver"]["max_cg_iterations"] = 20
    cfg["solver"]["max_iterations"] = 25
    return cfg


def test_held_back_problem():
    """Frames 0 … 7 of 12 kept: poses 0 … 8 (the last frame's exposure ends
    at pose 8), the valid observations of those frames and the points they
    see, renumbered in order; gt and start cut to them."""
    sc = generator.make_scene(_cfg()["generator"], 3)
    sub, points = solve_resolve.held_back(sc, 4, pad_to=64)
    m = (sc.mask > 0) & (sc.pose_a < 8)
    n = int(m.sum())
    assert sub.n_poses == 9 and sub.pose_free.shape == (9,)
    assert sub.uv.shape[0] % 64 == 0 and sub.n_valid == n
    np.testing.assert_array_equal(points, np.unique(sc.point[m]))
    assert sub.n_points == points.shape[0] < sc.n_points
    np.testing.assert_array_equal(points[sub.point[:n]], sc.point[m])
    for f in ("uv", "t", "pose_a", "pose_b"):
        np.testing.assert_array_equal(getattr(sub, f)[:n],
                                      getattr(sc, f)[m])
    assert not sub.mask[n:].any() and sub.pose_b[:n].max() == 8
    np.testing.assert_array_equal(sub.gt["points"], sc.gt["points"][points])
    np.testing.assert_array_equal(sub.start["q"], sc.start["q"][:9])
    np.testing.assert_array_equal(sub.start["points"],
                                  sc.start["points"][points])
    with pytest.raises(ValueError):
        solve_resolve.held_back(sc, 12)


def test_warm_start():
    """The held-back solution for its poses and points, the perturbed
    start for the new frames' poses and the points first seen in them."""
    sc = generator.make_scene(_cfg()["generator"], 3)
    sub, points = solve_resolve.held_back(sc, 4)
    solved = {k: sub.gt[k] + 1e-3 for k in ("q", "c", "points")}
    w = solve_resolve.warm_start(sc, points, solved)
    np.testing.assert_array_equal(w["q"][:9], solved["q"])
    np.testing.assert_array_equal(w["c"][:9], solved["c"])
    np.testing.assert_array_equal(w["q"][9:], sc.start["q"][9:])
    np.testing.assert_array_equal(w["points"][points], solved["points"])
    new = np.setdiff1d(np.arange(sc.n_points), points)
    assert new.size > 0
    np.testing.assert_array_equal(w["points"][new], sc.start["points"][new])
    assert not np.shares_memory(w["q"], sc.start["q"])


# --- whole runs of the cell ------------------------------------------------

@pytest.fixture
def one_problem_pool(monkeypatch):
    """The cell's traffic with a pool of one problem and 2 frames held
    back: the same kind and check at a small size."""
    traffic = manifest.traffic
    monkeypatch.setattr(manifest, "traffic", lambda n: dict(
        traffic(n), pool_seeds=[1], held_back_frames=2))


def _cell_run(control="none"):
    return run.execute("rs_slerp_robust.resolve", SEED, 0.2, False,
                       device="cpu", cfg=_cfg(), control=control)


def test_sound_run_is_correct(one_problem_pool):
    out = _cell_run()
    assert out["correct"], out["check"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"solve_s", "setup_s"}


@pytest.mark.parametrize("fault,number", [("unchanged", "gn_gain"),
                                          ("half", "gn_gain"),
                                          ("altered", "cost_gap")])
def test_fault_is_not_correct(one_problem_pool, monkeypatch, fault, number):
    faults.plant("solve", fault, monkeypatch.setattr)
    out = _cell_run()
    assert not out["correct"]
    c = out["check"][number]
    assert c["value"] > c["limit"], out["check"]


def test_control_in_bfloat16_is_not_correct(one_problem_pool):
    out = _cell_run(control="bf16")
    assert not out["correct"]
    for n in ("gn_gain", "cost_gap", "rmse_gap"):
        assert out["check"][n]["value"] > out["check"][n]["limit"], n
