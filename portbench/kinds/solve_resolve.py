"""Traffic kind ``solve_resolve``: the re-solve that a SLAM or SfM back end
runs after new frames arrive, from the solution it already has.

Set-up makes the ``solve`` kind's pool (``kinds/solve.py``: generator
seeds ``pool_seeds``, in the order the seed sets) and, for each problem,
a problem of its own with the last ``held_back_frames`` frames held back:
its first frames, their poses, the points those frames observe and only
those observations (``held_back``).  It solves that problem as the
program's user would (``rsba_tpu_torch.solver.solve`` with no ``fns``),
and the whole problem's start becomes that solution for the old poses and
points and the generator's perturbed start for the new frames' poses and
for the points first seen in them (``warm_start``).  With ``--control bf16``
the control solves the held-back problem in the program's place (the
reference in bfloat16, ``control_steps`` steps).

Traffic parameters (``traffic/<name>.json``): the ``solve`` kind's, and
  held_back_frames   the frames held back from set-up's solve

The window, release and the check are the ``solve`` kind's, run as they
are on those problems and starts: a closed loop of whole solves of the
whole problem, each request a new ``Problem`` and ``Params`` copied to the
card, plan and capture inside each, and ``correct`` against the float64
reference (``reference/lsq.py``): ``gn_gain``, ``cost_gap``,
``rmse_gap`` and ``failed``.  The ``solve`` kind reaches the generator
through its module name ``generator``, which is bound here, while its
set-up runs, to one that hands out the warm-started problems.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from ..reference import generator, lsq
from . import solve
from .solve import State, check, release, window  # noqa: F401


def held_back(scene, frames: int, pad_to: int = 256):
    """``scene`` without its last ``frames`` frames: (the problem of the
    first frames, the whole problem's index of each of its points).  Its
    poses are the first frames' (and, under rolling shutter, the pose that
    ends the last of them); its observations are the valid ones of those
    frames, padded to a multiple of ``pad_to`` as the generator pads."""
    rs = scene.model["rolling_shutter"]
    n_frames = scene.n_poses - 1 if rs else scene.n_poses
    kept = n_frames - frames
    if kept < 1:
        raise ValueError("nothing is left of the scene")
    P = kept + 1 if rs else kept
    obs = np.nonzero((scene.mask > 0) & (scene.pose_a < kept))[0]
    points = np.unique(scene.point[obs])
    total = obs.shape[0] + (-obs.shape[0] % pad_to)

    def pad(a):
        out = np.zeros((total,) + a.shape[1:], dtype=a.dtype)
        out[:obs.shape[0]] = a
        return out

    sub = dataclasses.replace(
        scene, uv=pad(scene.uv[obs]), t=pad(scene.t[obs]),
        pose_a=pad(scene.pose_a[obs]), pose_b=pad(scene.pose_b[obs]),
        point=pad(np.searchsorted(points, scene.point[obs]).astype(np.int32)),
        mask=pad(scene.mask[obs]), pose_free=scene.pose_free[:P].copy(),
        gt={"q": scene.gt["q"][:P], "c": scene.gt["c"][:P],
            "points": scene.gt["points"][points]},
        start={"q": scene.start["q"][:P], "c": scene.start["c"][:P],
               "points": scene.start["points"][points]})
    return sub, points


def warm_start(scene, points: np.ndarray, solved: dict) -> dict:
    """The whole problem's start: ``solved`` (q, c, points of the held-back
    problem) for its poses and ``points``, the perturbed start elsewhere."""
    start = {k: np.array(v, dtype=np.float64, copy=True)
             for k, v in scene.start.items()}
    P = solved["q"].shape[0]
    start["q"][:P] = solved["q"]
    start["c"][:P] = solved["c"]
    start["points"][points] = solved["points"]
    return start


def _solve_held_back(sub, cfg: dict, device, control: str,
                     control_steps: int) -> dict:
    """The held-back problem solved by the program, or by the control."""
    if control == "bf16":
        p, _ = lsq.optimum(lsq.Data.of(sub, device, torch.bfloat16),
                           lsq.params_on(sub.start, device, torch.bfloat16),
                           max_steps=control_steps)
        return {k: p[k].double().cpu().numpy() for k in ("q", "c", "points")}
    from rsba_tpu_torch.solver import lm
    from rsba_tpu_torch.solver.options import SolverOptions
    h = solve._host_inputs(sub, getattr(np, cfg["dtype"]))
    params, _ = lm.solve(*solve._program_inputs(h, device),
                         SolverOptions(**cfg["solver"]))
    return {k: getattr(params, k).double().cpu().numpy()
            for k in ("q", "c", "points")}


class _Warm:
    """Stands in for the generator module: the warm-started problem of
    each pool seed."""

    def __init__(self, scenes: dict):
        self.scenes = scenes

    def make_scene(self, p: dict, seed: int, device="cpu"):
        return self.scenes[seed]


@contextlib.contextmanager
def _warm_generator(scenes: dict):
    saved = solve.generator
    solve.generator = _Warm(scenes)
    try:
        yield
    finally:
        solve.generator = saved


def setup(cfg: dict, traffic: dict, seed: int, device, control: str) -> State:
    warm = {}
    for s in traffic["pool_seeds"]:
        sc = generator.make_scene(cfg["generator"], int(s), device)
        sub, points = held_back(sc, traffic["held_back_frames"],
                                cfg["generator"].get("pad_to", 256))
        solved = _solve_held_back(sub, cfg, device, control,
                                  traffic["control_steps"])
        warm[int(s)] = dataclasses.replace(
            sc, start=warm_start(sc, points, solved))
    with _warm_generator(warm):
        return solve.setup(cfg, traffic, seed, device, control)
