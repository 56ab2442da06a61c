"""Time and profile the LM loops of the port on one CUDA GPU.

    python3 -m rsba_tpu_torch.tools.profile_loop [--config NAME]
        [--solves N] [--no-profile] [--config5]

For one preset at full size in float32 (default ``rs_slerp_robust``,
config 4) it prints, each line with the card's name and power limit:

* the wall time, attempts, accepted steps, summed CG iterations, host
  read-backs and kernel launches of whole solves, taken in turns: the
  captured on-device loop with the prepare as a graph of its own, the
  same loop with a prepare in every attempt's graph, and the host loop;
* the time of one replay of the attempt graph and of the prepare graph
  (CUDA events over ten replays after a solve has ended), and of the
  parts of an attempt, each captured in a graph of its own at the solve's
  final state: the prepare and the fused kernel in it, the reduced system
  (the F C⁻¹ Fᵀ band and its folds), PCG's 100 passes, the whole solve
  step, and the retraction with its one residual pass;
* from one ``torch.profiler`` window over one solve of each loop: device
  launches, summed device time, the device-busy share of the window,
  and the kernels that take most of the device's time, with launches ×
  mean time;
* with ``--config5``, one solve of ``rs_mhost_pcg`` (10,001 poses, 1M
  points) through the default options, with its peak device memory.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import torch

def log(msg: str) -> None:
    print(msg, flush=True)


def _solve(ba, opts, fns, tag, card):
    from ..kernels import fused
    from ..solver import solve
    fused.fused_evaluate_assemble_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, s = solve(ba.problem, ba.params0, opts, fns=fns)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    seq = "".join("A" if it.accepted else "r" for it in s.iterations)
    cg = sum(it.linear_solver_iterations for it in s.iterations)
    log(f"[{card}] {ba.name} {tag}: {s.linear_solver}/{s.evaluator} "
        f"{s.termination} ({s.message}), wall {wall:.4f} s, records "
        f"{s.num_iterations} ({s.num_successful_steps} accepted) {seq}, "
        f"CG iterations {cg}, host reads {s.host_reads}, kernel launches "
        f"{fused.fused_evaluate_assemble_cuda.launches}, inlier RMSE "
        f"{s.final_rmse_inlier:.5f} px")
    return s, wall


def _replay_ms(graph, n=10):
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def _graph_ms(fn, n=10):
    """Capture ``fn`` in a CUDA graph of its own; ms per replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        keep = fn()                      # noqa: F841 (outputs stay alive)
    return _replay_ms(graph, n)


def _part_times(ba, opts, fns, runner, card):
    """Graph-replay times of the parts of one attempt of the banded
    engine, at the state the runner's last solve ended in."""
    from ..kernels import fused
    from ..solver import banded, banded_fused
    from ..solver.pcg import pcg
    raw = fns["raw"]
    plan, problem = raw["bound"]
    st = runner.state
    statics = banded_fused.kernel_statics(plan, problem)
    inp = banded_fused.kernel_inputs(st.params, plan, problem, statics)
    S, b, _, _, _ = banded_fused.reduced_system(plan, opts, st.aux,
                                                st.radius)
    matvec = banded.make_band_matvec(S)
    precond = banded.make_band_preconditioner(S, opts.preconditioner)
    dx, _, _ = raw["solve_step"](raw["bound"], st.aux, st.radius)

    def retract_and_decrease():
        cand, _, _ = raw["apply_step"](raw["bound"], st.params, dx)
        return raw["cost_decrease_pair"](raw["bound"], st.rho_ref, cand)

    parts = {
        "prepare (kernel, folds, Jacobi scaling)":
            lambda: raw["prepare"](raw["bound"], st.params),
        "fused kernel alone": lambda: fused.fused_evaluate_assemble_cuda(
            *inp, model=problem.model, loss=problem.loss),
        "reduced system (F C^-1 F^T band, folds, rhs)":
            lambda: banded_fused.reduced_system(plan, opts, st.aux,
                                                st.radius),
        "band rows + preconditioner set-up": lambda: (
            banded.make_band_matvec(S),
            banded.make_band_preconditioner(S, opts.preconditioner)),
        f"pcg, {opts.max_cg_iterations} passes": lambda: pcg(
            matvec, precond, b.reshape(-1), opts.max_cg_iterations,
            opts.cg_eta),
        "one band product": lambda: matvec(b.reshape(-1)),
        "whole solve_step": lambda: raw["solve_step"](raw["bound"], st.aux,
                                                      st.radius),
        "apply_step + one residual pass": retract_and_decrease,
    }
    before = fused.fused_evaluate_assemble_cuda.launches
    for name, fn in parts.items():
        log(f"[{card}] {ba.name} part, one graph replay: {name}: "
            f"{_graph_ms(fn):.3f} ms")
    fused.fused_evaluate_assemble_cuda.launches = before


def _profiled(ba, opts, fns, tag, card, top=14):
    from torch.profiler import ProfilerActivity, profile
    from ..solver import solve
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve(ba.problem, ba.params0, opts, fns=fns)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time for e in dev)
    log(f"[{card}] {ba.name} {tag} under torch.profiler: wall {wall:.4f} s, "
        f"device launches {len(dev)}, device time {busy_us / 1e6:.4f} s, "
        f"device busy {100 * busy_us / 1e6 / wall:.1f}% of the window")
    by_name = {}
    for e in dev:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.device_time)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    for name, (n, t) in ranked:
        log(f"    {t / 1e3:9.3f} ms = {n:6d} x {t / n:8.2f} us  "
            f"{name[:100]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="rs_slerp_robust")
    ap.add_argument("--solves", type=int, default=3)
    ap.add_argument("--no-profile", action="store_true")
    ap.add_argument("--config5", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the loops are timed on a GPU")
    from ..kernels import build
    from ..problem import synthetic
    from ..solver import SolverOptions, lm_device, make_solver_fns
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    build.load("fused_evaluate_assemble")

    ba = synthetic.CONFIGS[args.config](scale=1.0, dtype=torch.float32,
                                        device="cuda")
    loop = SolverOptions(max_iterations=60)
    host = SolverOptions(max_iterations=60, device_loop="off")
    fns = make_solver_fns(ba.problem, loop)
    # The same engine with a runner that captures a prepare into every
    # attempt's graph, for the comparison of the two forms.
    n = lm_device.block_size(loop, False)
    fns_every = dict(fns, _device_runners={
        (n, loop): lm_device.make_device_runner(fns["raw"], loop, n,
                                                prepare_in_attempt=True)})
    _solve(ba, loop, fns, "captured loop, first solve (warm-up and capture)",
           card)
    _solve(ba, loop, fns_every, "prepare in every attempt, first solve "
           "(capture)", card)
    for i in range(args.solves):
        _solve(ba, loop, fns, f"captured loop, prepare on a flag #{i}", card)
        _solve(ba, loop, fns_every, f"captured loop, prepare in every "
               f"attempt #{i}", card)
        _solve(ba, host, fns, f"host loop #{i}", card)
    runners = (list(fns["_device_runners"].values())
               + list(fns_every["_device_runners"].values()))
    for runner in runners:
        g_attempt, g_prepare = runner.graphs
        what = ("attempt + prepare graph" if g_prepare is None
                else "attempt graph")
        log(f"[{card}] {ba.name} one replay of the {what}: "
            f"{_replay_ms(g_attempt):.3f} ms"
            + ("" if g_prepare is None else
               f"; of the prepare graph: {_replay_ms(g_prepare):.3f} ms"))
        if g_prepare is not None and fns["engine"][0] == "banded_schur":
            _part_times(ba, loop, fns, runner, card)
    if not args.no_profile:
        _profiled(ba, loop, fns, "captured loop", card)
        _profiled(ba, host, fns, "host loop", card)
    del ba, fns, fns_every, runners
    torch.cuda.empty_cache()

    if args.config5:
        t0 = time.perf_counter()
        ba = synthetic.CONFIGS["rs_mhost_pcg"](scale=1.0,
                                               dtype=torch.float32,
                                               device="cuda")
        torch.cuda.synchronize()
        log(f"[{card}] rs_mhost_pcg: {ba.problem.pose_free.numel()} poses, "
            f"{ba.problem.point_free.numel()} points, "
            f"{int(ba.problem.obs.mask.sum())} observations, generated in "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        fns = make_solver_fns(ba.problem, SolverOptions())
        log(f"[{card}] rs_mhost_pcg: plan and engine built in "
            f"{time.perf_counter() - t0:.1f} s")
        torch.cuda.reset_peak_memory_stats()
        for tag in ("first solve (warm-up and capture)", "second solve"):
            _solve(ba, SolverOptions(), fns, "default options, " + tag, card)
            log(f"[{card}] rs_mhost_pcg max_memory_allocated "
                f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    return 0


if __name__ == "__main__":
    raise SystemExit(main())
