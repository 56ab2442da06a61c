"""Traffic kind ``solve``: a closed loop of whole solves.

One solve at a time, through the program's public entry point
``rsba_tpu_torch.solver.solve(problem, params, options)`` with no
``fns``, so that each call builds its window plan and captures its
graphs, as a user's call does; each ends in ``torch.cuda.synchronize()``.
The loop cycles through a pool of problems made in set-up as host
arrays.  Each request copies its problem and start to the card and
builds a new ``Problem`` and ``Params`` from them, as a user hands over
data, so nothing that the program could keep by the object from one
call to the next is reused; the arrays themselves repeat every
``len(pool_seeds)`` requests.  Every run gets the same pool, so that
every run does the same work: ``--seed`` sets which problem comes first
and which solves are checked.

Traffic parameters (``traffic/<name>.json``):
  pool_seeds     the generator's seeds of the pool's problems; each solve
                 starts from the generator's perturbed start
  checked        solves of the window compared with the reference
  trace_solves   solves profiled in a traced run (the first of the window)
  control_steps  Levenberg-Marquardt steps of the control's solve

In a traced run every request is split into ``make_solver_fns`` and
``solve(..., fns=fns)``, the same work, so that the plan has a span.

``correct``: a sample of the window's solves, drawn from the seed as
the window runs (a reservoir: only the sampled solves' answers are kept,
copied on the card, and read once the window has closed), is held to
the float64 reference (``reference/lsq.py``).  At each sampled solve's
parameters the reference takes one Gauss-Newton step of its own:
``gn_gain`` is the decrease its model predicts, as a share of the cost
(zero at a stationary point); ``cost_gap`` and ``rmse_gap`` set the cost
and inlier RMSE that the solve reported against the reference's at its
parameters.  A solve that raised or did not end in CONVERGENCE is
``failed``.

The control (``--control bf16``) puts the reference in the program's
place, its residuals and Jacobians computed in bfloat16 (the precision
below the configuration's float32; its normal equations in float64):
``control_steps`` of its Levenberg-Marquardt steps from the same start,
reporting the cost and inlier RMSE of its bfloat16 residuals.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..reference import generator, lsq


@dataclasses.dataclass
class State:
    scenes: list
    host: list              # the program's inputs of each scene, host arrays
    options: object
    traffic: dict
    seed: int
    device: object
    control: list = None    # the control's bfloat16 data of each scene


def _host_inputs(scene, dtype) -> dict:
    """The scene as the program takes it, in host arrays of its dtypes."""
    f = lambda a: np.ascontiguousarray(a, dtype=dtype)  # noqa: E731
    i = lambda a: np.ascontiguousarray(a, dtype=np.int32)  # noqa: E731
    return {"uv": f(scene.uv), "t": f(scene.t), "pose_a": i(scene.pose_a),
            "pose_b": i(scene.pose_b), "point": i(scene.point),
            "intr_idx": i(np.zeros_like(scene.point)), "mask": f(scene.mask),
            "pose_free": f(scene.pose_free), "intr": f(scene.intr),
            "q": f(scene.start["q"]), "c": f(scene.start["c"]),
            "points": f(scene.start["points"]), "scene": scene}


def _program_inputs(h: dict, device):
    """A new ``Problem`` and start ``Params`` on ``device`` from host
    arrays, through the program's public types."""
    from rsba_tpu_torch.geometry import CameraModel, Loss
    from rsba_tpu_torch.problem.types import (Observations, Params,
                                              make_problem)
    on = lambda k: torch.from_numpy(h[k]).to(device)  # noqa: E731
    obs = Observations(uv=on("uv"), t=on("t"), pose_a=on("pose_a"),
                       pose_b=on("pose_b"), intr_idx=on("intr_idx"),
                       point=on("point"), mask=on("mask"))
    sc = h["scene"]
    m = sc.model
    problem = make_problem(
        obs, sc.n_poses, sc.n_points, 1,
        CameraModel(rolling_shutter=m["rolling_shutter"],
                    rotation_interp=m["interp"],
                    use_distortion=m["distortion"]),
        Loss(sc.loss["kind"], float(sc.loss["scale"])),
        dtype=obs.uv.dtype, device=device)
    problem = problem.replace(pose_free=on("pose_free"))
    params = Params(q=on("q"), c=on("c"), intr=on("intr"),
                    points=on("points"))
    return problem, params


def setup(cfg: dict, traffic: dict, seed: int, device, control: str) -> State:
    from rsba_tpu_torch.solver import lm
    from rsba_tpu_torch.solver.options import SolverOptions
    dtype = getattr(np, cfg["dtype"])
    seeds = traffic["pool_seeds"]
    first = int(np.random.SeedSequence(seed).generate_state(1)[0]) \
        % len(seeds)
    scenes = [generator.make_scene(cfg["generator"], int(s), device)
              for s in seeds[first:] + seeds[:first]]
    st = State(scenes, [_host_inputs(sc, dtype) for sc in scenes],
               SolverOptions(**cfg["solver"]), traffic, seed, device)
    if control == "bf16":
        st.control = [lsq.Data.of(sc, device, torch.bfloat16)
                      for sc in scenes]
    else:
        lm.solve(*_program_inputs(st.host[0], device), st.options)  # warm-up
    _sync(device)
    return st


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class _Reservoir:
    """Which of the window's solves are kept for the check: ``n`` drawn
    uniformly from those completed so far, from the seed's stream."""

    def __init__(self, n: int, seed: int):
        self.n = n
        self.rng = np.random.default_rng(
            np.random.SeedSequence(seed).generate_state(2))
        self.seen = 0
        self.kept = [None] * n

    def offer(self, rec: dict, answer: dict) -> None:
        j = self.seen if self.seen < self.n else \
            int(self.rng.integers(0, self.seen + 1))
        self.seen += 1
        if j < self.n:
            if self.kept[j] is not None:
                self.kept[j].pop("params", None)
            rec["params"] = {k: v.detach().clone()
                             for k, v in answer.items()}
            self.kept[j] = rec


def _result(summary) -> dict:
    """What a record keeps of the program's ``Summary``."""
    return dict(ok=summary.termination == "CONVERGENCE",
                termination=summary.termination,
                attempts=summary.num_iterations,
                cg_iters=sum(it.linear_solver_iterations
                             for it in summary.iterations),
                final_cost=summary.final_cost,
                final_rmse_inlier=summary.final_rmse_inlier)


def _control_solve(st: State, i: int):
    """The reference in the program's place, in bfloat16: its answer and
    what it reports."""
    p, out = lsq.optimum(st.control[i],
                         lsq.params_on(st.scenes[i].start, st.device,
                                       torch.bfloat16),
                         max_steps=st.traffic["control_steps"])
    return p, dict(ok=True, termination="control", attempts=out["steps"],
                   cg_iters=0, final_cost=out["cost"],
                   final_rmse_inlier=out["rmse_inlier"])


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
        rec = {"problem": i, "ok": False}
        t0 = time.perf_counter()
        try:
            if st.control is not None:
                answer, result = _control_solve(st, i)
            elif tracer.enabled:
                with tracer.span("plan"):
                    problem, start = _program_inputs(st.host[i], device)
                    fns = lm.make_solver_fns(problem, st.options)
                    _sync(device)
                rec["plan_s"] = time.perf_counter() - t0
                with tracer.span("solve"):
                    params, summary = lm.solve(problem, start, st.options,
                                               fns=fns)
                    _sync(device)
                if tracer.active:
                    plan = fns["raw"]["bound"][0] if "raw" in fns else None
                    rec["plan_shape"] = (plan.NR, plan.W, plan.L, plan.G) \
                        if plan is not None else None
            else:
                problem, start = _program_inputs(st.host[i], device)
                params, summary = lm.solve(problem, start, st.options)
                _sync(device)
            if st.control is None:
                answer = {f: getattr(params, f) for f in ("q", "c", "points")}
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
    """The fused kernel's bound per launch (``roofline.kernel_bound``
    from each profiled problem's shapes), averaged over the launches of
    the profiled solves."""
    from .. import roofline
    bound, launches = 0.0, 0
    for rec in run.solves:
        if not rec.get("traced") or not rec.get("plan_shape"):
            continue
        sc = st.scenes[rec["problem"]]
        NR, W, L, G = rec["plan_shape"]
        m = sc.model
        flops = roofline.slot_flops(m["rolling_shutter"], m["interp"],
                                    m["distortion"],
                                    sc.loss["kind"] != "trivial")
        b = roofline.kernel_bound(NR, W, L, G, st.host[rec["problem"]]["uv"].itemsize,
                                  sc.n_valid, flops)
        bound += b["bound_s"] * rec["launches"]
        launches += rec["launches"]
    if launches:
        run.counters["fused_bound_s"] = bound / launches


def release(st: State) -> None:
    st.host = []
    st.control = None


def check(st: State, run, limits: dict, device) -> list:
    """(name, value, limit) of each number compared."""
    sample = [r for r in run.solves if "params" in r]
    gain, cost_gap, rmse_gap = [], [], []
    data = {}
    for rec in sample:
        i = rec["problem"]
        if i not in data:
            data[i] = lsq.Data.of(st.scenes[i], device)
        p = lsq.params_on(rec.pop("params"), device)
        got = lsq.cost_stats(data[i], p)
        g = lsq.gauss_newton_gain(data[i], p)
        gain.append(g["gain"] / got["cost"])
        cost_gap.append(abs(rec["final_cost"] - got["cost"]) / got["cost"])
        rmse_gap.append(abs(rec["final_rmse_inlier"] - got["rmse_inlier"]))
    worst = lambda v: max(v) if v else float("inf")  # noqa: E731
    return [("failed", float(run.failed), 0.0),
            ("gn_gain", worst(gain), limits["gn_gain"]),
            ("cost_gap", worst(cost_gap), limits["cost_gap"]),
            ("rmse_gap", worst(rmse_gap), limits["rmse_gap"])]
