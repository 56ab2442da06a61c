"""A run with the timed path broken underneath comes out not correct.

Each test drives a whole run on the CPU at a small size (the look for a
card is skipped: ``run.execute(..., device="cpu")``), once sound, once
with one fault of ``tools/faults.py`` planted in the program (a step
that returns its state unchanged, half of the observations left out, an
answer altered where it is produced), and once as the control (the
reference in bfloat16 in the program's place).  The cells run on one
card, so no exchange between cards can be left out.
"""
import pytest
import torch

from portbench import manifest, run
from portbench.tools import faults

torch.set_num_threads(2)
BENCH = manifest.load()
SEED = 2**31 + 17


def _solve_cfg():
    cfg = manifest.config(BENCH, "rs_slerp_robust")
    cfg["generator"].update(n_poses=21, n_points=1000)
    return cfg


def _session_cfg():
    cfg = manifest.config(BENCH, "rs_video_linear")
    cfg["generator"].update(n_poses=25, n_points=2000)
    return cfg


def _solve_run(seed=SEED, control="none"):
    return run.execute("rs_slerp_robust.cold", seed, 1.0, False,
                       device="cpu", cfg=_solve_cfg(), control=control)


#: the session's limits at this size, where its frames reproject less
#: well than at full size and by how far the window got (sound runs read
#: 7.7-15 px and 0.002-0.006 rad; an altered pose 22 px and 0.040 rad)
SESSION_LIMITS = {"rot_err_rad": 0.02, "frame_rmse_max_px": 50.0,
                  "bad_point_share": 0.05}


def _session_run(control="none"):
    return run.execute("rs_video_linear.session", SEED, 12.0, False,
                       device="cpu", cfg=_session_cfg(),
                       limits=SESSION_LIMITS, control=control)


@pytest.mark.parametrize("seed", [SEED, 2**32 + 5])
def test_sound_solve_run_is_correct(seed):
    out = _solve_run(seed)
    assert out["correct"], out["check"]
    assert out["failed"] == 0 and out["attempted"] >= 1


@pytest.mark.parametrize("fault,number", [("unchanged", "gn_gain"),
                                          ("half", "gn_gain"),
                                          ("altered", "cost_gap")])
def test_solve_fault_is_not_correct(monkeypatch, fault, number):
    faults.plant("solve", fault, monkeypatch.setattr)
    out = _solve_run()
    assert not out["correct"]
    c = out["check"][number]
    assert c["value"] > c["limit"], out["check"]


def test_sound_session_run_is_correct():
    out = _session_run()
    assert out["correct"], out["check"]
    assert out["attempted"] >= 5


@pytest.mark.parametrize("fault,number", [("unregistered", "failed"),
                                          ("altered", "rot_err_rad")])
def test_session_fault_is_not_correct(monkeypatch, fault, number):
    faults.plant("session", fault, monkeypatch.setattr)
    out = _session_run()
    assert not out["correct"]
    c = out["check"][number]
    assert c["value"] > c["limit"], out["check"]


def test_limits_of_each_configuration_and_kind():
    solve = manifest.limits("rs_slerp_robust", "solve")
    session = manifest.limits("rs_video_linear", "session")
    assert set(solve) == {"gn_gain", "cost_gap", "rmse_gap"}
    assert set(session) == {"rot_err_rad", "frame_rmse_max_px",
                            "bad_point_share"}
    assert all(v > 0 for v in list(solve.values()) + list(session.values()))


def test_solve_control_in_bfloat16_is_not_correct():
    """The reference's steps with bfloat16 residuals and Jacobians stop
    short of the optimum, and report their own bfloat16 cost."""
    out = _solve_run(control="bf16")
    assert not out["correct"]
    assert out["check"]["gn_gain"]["value"] > out["check"]["gn_gain"]["limit"]
    assert out["check"]["cost_gap"]["value"] > \
        out["check"]["cost_gap"]["limit"]


def test_session_control_in_bfloat16_reads_above_the_truth():
    """The session's control rounds the poses and points it hands the
    check through bfloat16: at the ground truth of a small sequence it
    reads above the truth itself (the cell's limits are held at full
    size on the card; PERF.md gives both readings)."""
    from portbench.kinds import session
    from portbench.record import Run
    from portbench.reference import generator
    cfg = _session_cfg()
    sc = generator.make_scene(cfg["generator"], 3, "cpu")
    truth = type("Truth", (), {
        "n_frames": sc.n_poses, "registered": [True] * sc.n_poses,
        "reconstruction": lambda self: (
            sc.gt["q"], sc.gt["c"],
            {k: sc.gt["points"][k] for k in range(sc.n_points)})})()
    read = {}
    for control in ("none", "bf16"):
        st = session.State(cfg, sc, [], None, {}, control)
        st.snapshots.append(session._snapshot(st, truth))
        read[control] = {n: v for n, v, _ in
                         session.check(st, Run(kind="session"),
                                       SESSION_LIMITS, "cpu")}
    assert read["none"]["rot_err_rad"] < 1e-9
    assert read["bf16"]["rot_err_rad"] > 1e-4
    assert read["bf16"]["frame_rmse_max_px"] > \
        read["none"]["frame_rmse_max_px"] + 0.1


def test_reservoir_keeps_a_sample_drawn_from_the_seed():
    from portbench.kinds.solve import _Reservoir

    def kept(seed, n_solves):
        keep, recs = _Reservoir(2, seed), []
        for k in range(n_solves):
            recs.append({"k": k})
            keep.offer(recs[-1], {"q": torch.full((2,), float(k))})
        return [r["k"] for r in recs if "params" in r]
    assert kept(SEED, 1) == [0]
    assert kept(SEED, 40) == kept(SEED, 40)
    assert len(kept(SEED, 40)) == 2
    assert len({tuple(kept(s, 40)) for s in range(8)}) > 1
