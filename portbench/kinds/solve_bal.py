"""Traffic kind ``solve_bal``: the ``solve`` kind's closed loop of whole
solves, on BAL-style problems whose every camera has its own intrinsics,
focal length, k1 and k2 optimised (``reference/generator_bal.py``).

Each request copies its problem to the card as a new ``Problem`` and
``Params`` (``n_intr`` = one block a camera, ``intr_idx`` = the camera,
the program's ``intr_basis_bal``, each camera's perturbed intrinsics in
the start) and calls ``rsba_tpu_torch.solver.solve(problem, params,
options)`` with no ``fns``, ending in ``torch.cuda.synchronize()``.  The
pool, the seed's part, the traffic parameters and the record of each
solve are the ``solve`` kind's (``kinds/solve.py``), whose helpers this
kind imports.

Set-up solves every pool problem once, so that the program's engine
cache (``lm_device.engines``) holds each problem's engine and captured
graphs: every request of the window then finds them, compares the index
arrays, copies the data in and replays.  Traced requests call ``solve``
the same way; the cache keys on tracing, so each traced request builds
and captures an engine with device spans, its plan (span ``plan``) inside
``solve``.

``correct``: as the ``solve`` kind, against the float64 reference
``reference/lsq_bal.py`` at each sampled solve's poses, intrinsics and
points.  The control (``--control bf16``) is that reference in the
program's place with bfloat16 residuals and Jacobians, ``control_steps``
of its Levenberg-Marquardt steps.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import roofline_bal, spans
from ..reference import generator_bal, lsq_bal
from .solve import State, _Reservoir, _result, _sync, release  # noqa: F401

FIELDS = ("q", "c", "intr", "points")


def _host_inputs(scene, dtype) -> dict:
    """The scene as the program takes it, in host arrays of its dtypes."""
    f = lambda a: np.ascontiguousarray(a, dtype=dtype)  # noqa: E731
    i = lambda a: np.ascontiguousarray(a, dtype=np.int32)  # noqa: E731
    h = {k: i(getattr(scene, k))
         for k in ("pose_a", "pose_b", "point", "intr_idx")}
    h.update({k: f(getattr(scene, k))
              for k in ("uv", "t", "mask", "pose_free")})
    h.update({k: f(scene.start[k]) for k in FIELDS})
    h["scene"] = scene
    return h


def _program_inputs(h: dict, device):
    """A new ``Problem`` and start ``Params`` on ``device`` from host
    arrays, through the program's public types."""
    from rsba_tpu_torch.geometry import CameraModel, Loss
    from rsba_tpu_torch.problem.types import (Observations, Params,
                                              intr_basis_bal, make_problem)
    on = lambda k: torch.from_numpy(h[k]).to(device)  # noqa: E731
    obs = Observations(uv=on("uv"), t=on("t"), pose_a=on("pose_a"),
                       pose_b=on("pose_b"), intr_idx=on("intr_idx"),
                       point=on("point"), mask=on("mask"))
    sc = h["scene"]
    problem = make_problem(
        obs, sc.n_poses, sc.n_points, h["intr"].shape[0],
        CameraModel(rolling_shutter=False,
                    use_distortion=sc.model["distortion"]),
        Loss(sc.loss["kind"], float(sc.loss["scale"])),
        intr_basis=intr_basis_bal(h["uv"].dtype), dtype=obs.uv.dtype,
        device=device)
    problem = problem.replace(pose_free=on("pose_free"))
    return problem, Params(*(on(k) for k in FIELDS))


def setup(cfg: dict, traffic: dict, seed: int, device, control: str) -> State:
    from rsba_tpu_torch.solver import lm
    from rsba_tpu_torch.solver.options import SolverOptions
    dtype = getattr(np, cfg["dtype"])
    seeds = traffic["pool_seeds"]
    first = int(np.random.SeedSequence(seed).generate_state(1)[0]) \
        % len(seeds)
    scenes = [generator_bal.make_scene(cfg["generator"], int(s), device)
              for s in seeds[first:] + seeds[:first]]
    st = State(scenes, [_host_inputs(sc, dtype) for sc in scenes],
               SolverOptions(**cfg["solver"]), traffic, seed, device)
    if control == "bf16":
        st.control = [lsq_bal.Data.of(sc, device, torch.bfloat16)
                      for sc in scenes]
    else:
        for h in st.host:                      # an engine for each problem
            lm.solve(*_program_inputs(h, device), st.options)
    _sync(device)
    return st


def _control_solve(st: State, i: int):
    """The reference in the program's place, in bfloat16: its answer and
    what it reports."""
    p, out = lsq_bal.optimum(st.control[i],
                             lsq_bal.params_on(st.scenes[i].start, st.device,
                                               torch.bfloat16),
                             max_steps=st.traffic["control_steps"])
    return p, dict(ok=True, termination="control", attempts=out["steps"],
                   cg_iters=0, final_cost=out["cost"],
                   final_rmse_inlier=out["rmse_inlier"])


def _reduced_spans() -> int:
    return len(spans.named(spans.records(), "reduced_system", device=True))


def window(st: State, seconds: float, run, tracer) -> None:
    from rsba_tpu_torch.kernels import fused
    from rsba_tpu_torch.solver import lm, lm_device
    device = st.device
    n_trace = st.traffic.get("trace_solves", 2)
    keep = _Reservoir(st.traffic["checked"], st.seed)
    t_start = time.perf_counter()
    k = 0
    while True:
        i = k % len(st.host)
        if tracer.enabled and k < n_trace:
            tracer.start()
        cap0 = lm_device._Runner.capture_seconds
        launches0 = fused.fused_evaluate_assemble_cuda.launches
        spans0 = _reduced_spans() if tracer.active else 0
        rec = {"problem": i, "ok": False}
        t0 = time.perf_counter()
        try:
            if st.control is not None:
                answer, result = _control_solve(st, i)
            else:
                with tracer.span("solve"):
                    problem, start = _program_inputs(st.host[i], device)
                    params, summary = lm.solve(problem, start, st.options)
                    _sync(device)
                answer = {f: getattr(params, f) for f in FIELDS}
                result = _result(summary)
            rec["wall_s"] = time.perf_counter() - t0
            rec.update(result)
            keep.offer(rec, answer)
        except Exception as e:                       # noqa: BLE001
            rec["wall_s"] = time.perf_counter() - t0
            rec["error"] = f"{type(e).__name__}: {e}"
        rec["capture_s"] = lm_device._Runner.capture_seconds - cap0
        rec["launches"] = fused.fused_evaluate_assemble_cuda.launches \
            - launches0
        rec["traced"] = tracer.active
        if tracer.active:
            rec["reduced_spans"] = _reduced_spans() - spans0
        if tracer.active and k + 1 >= n_trace:
            tracer.stop()
        run.solves.append(rec)
        run.failed += 0 if rec["ok"] else 1
        k += 1
        if time.perf_counter() - t_start >= seconds:
            break
    run.window_s = time.perf_counter() - t_start
    _slice_counters(st, run)


def _slice_counters(st: State, run) -> None:
    """The reduced system's bound (``roofline_bal.reduced_bound`` from
    each profiled problem's index arrays), averaged over the
    ``reduced_system`` spans of the profiled solves."""
    total, n = 0.0, 0
    bounds = {}
    for rec in run.solves:
        if not rec.get("reduced_spans"):
            continue
        i = rec["problem"]
        if i not in bounds:
            h, sc = st.host[i], st.scenes[i]
            bounds[i] = roofline_bal.reduced_bound(
                h["point"], h["pose_a"], h["intr_idx"], h["mask"],
                sc.n_points, sc.n_poses, h["intr"].shape[0], 3,
                h["uv"].itemsize)["bound_s"]
        total += bounds[i] * rec["reduced_spans"]
        n += rec["reduced_spans"]
    if n:
        run.counters["dense_schur_reduced_bound_s"] = total / n


def check(st: State, run, limits: dict, device) -> list:
    """(name, value, limit) of each number compared (the ``solve`` kind's,
    against ``lsq_bal``)."""
    sample = [r for r in run.solves if "params" in r]
    gain, cost_gap, rmse_gap = [], [], []
    data = {}
    for rec in sample:
        i = rec["problem"]
        if i not in data:
            data[i] = lsq_bal.Data.of(st.scenes[i], device)
        p = lsq_bal.params_on(rec.pop("params"), device)
        got = lsq_bal.cost_stats(data[i], p)
        g = lsq_bal.gauss_newton_gain(data[i], p)
        gain.append(g["gain"] / got["cost"])
        cost_gap.append(abs(rec["final_cost"] - got["cost"]) / got["cost"])
        rmse_gap.append(abs(rec["final_rmse_inlier"] - got["rmse_inlier"]))
    worst = lambda v: max(v) if v else float("inf")  # noqa: E731
    return [("failed", float(run.failed), 0.0),
            ("gn_gain", worst(gain), limits["gn_gain"]),
            ("cost_gap", worst(cost_gap), limits["cost_gap"]),
            ("rmse_gap", worst(rmse_gap), limits["rmse_gap"])]
