"""CLI problem runner over the five config presets and BAL files.

Counterpart of ``rsba_tpu/cli/run.py``, with the same arguments and the
same final JSON line:

    python -m rsba_tpu_torch.cli.run --config=rs_slerp_robust --scale=0.1
    python -m rsba_tpu_torch.cli.run --bal=problem.txt --linear-solver=dense_schur
    python -m rsba_tpu_torch.cli.run --config=gs_small --device cpu

Per-config solver defaults: dense for config 1, dense_schur for config 2,
auto (the banded window solver) for the video configs 3 to 5.

Differences from the reference's CLI (each also in ``--help``):
``--device {cuda,cpu}`` (default cuda, an error without a card) takes the
place of ``--platform``; ``--dtype`` defaults to f32 on the card and f64
on the CPU; ``--evaluator`` is one of auto, cuda, torch; ``--profile-dir``
writes a ``torch.profiler`` Chrome trace; ``--debug-nans`` runs the host
loop and raises at the first non-finite cost, gradient or step; there is
no compile cache; ``--shard`` and ``--multihost`` are parsed and raise
NotImplementedError until the distributed solvers are ported (ROADMAP.md,
item 17).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time


CONFIG_SOLVER_DEFAULTS = {
    "gs_small": "dense",
    "gs_bal": "dense_schur",
    # Video configs: "auto" resolves to the banded window solver (the
    # fused CUDA kernel on the card, its plain version on the CPU).
    "rs_video_linear": "auto",
    "rs_slerp_robust": "auto",
    "rs_mhost_pcg": "auto",
}

_NOT_PORTED = ("is not ported yet: the distributed solvers are ROADMAP.md "
               "item 17")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rsba_tpu_torch.cli.run",
        description="Rolling-shutter bundle adjustment runner (PyTorch/CUDA)")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--config", choices=sorted(CONFIG_SOLVER_DEFAULTS),
                     help="synthetic config preset")
    src.add_argument("--bal", metavar="FILE",
                     help="BAL-format problem file (text, .gz or .bz2)")
    p.add_argument("--scale", type=float, default=1.0,
                   help="size multiplier for synthetic configs")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to run (takes the place of the reference's "
                        "--platform); cuda is an error without a card, "
                        "never a silent CPU run")
    p.add_argument("--dtype", choices=["f32", "f64"], default=None,
                   help="default: f32 on the card, f64 on the CPU")
    p.add_argument("--linear-solver",
                   choices=["auto", "dense", "dense_schur",
                            "iterative_schur", "banded_schur"],
                   default=None, help="default: per-config preset")
    p.add_argument("--evaluator", choices=["auto", "cuda", "torch"],
                   default="auto",
                   help="banded-solver evaluator: the fused CUDA kernel or "
                        "its plain PyTorch version (auto: the kernel on the "
                        "card, the plain version on the CPU)")
    p.add_argument("--preconditioner",
                   choices=["jacobi", "schur_jacobi", "cluster_jacobi"],
                   default="schur_jacobi",
                   help="PCG preconditioner; cluster_jacobi = trajectory "
                        "segments on the banded path, co-visibility camera "
                        "clusters on the flat iterative_schur path")
    p.add_argument("--trust-region-strategy", choices=["lm", "dogleg"],
                   default="lm",
                   help="dogleg (Ceres TRADITIONAL_DOGLEG) requires an "
                        "exact step solver: dense or dense_schur")
    p.add_argument("--check-gradients", action="store_true",
                   help="verify the forward-mode Jacobians against finite "
                        "differences before solving (Ceres "
                        "check_gradients); raises on mismatch")
    p.add_argument("--max-iterations", type=int, default=50)
    p.add_argument("--max-cg-iterations", type=int, default=100)
    p.add_argument("--cg-eta", type=float, default=1e-2)
    p.add_argument("--function-tolerance", type=float, default=1e-6)
    p.add_argument("--shard", action="store_true",
                   help="multi-GPU sharded solver; " + _NOT_PORTED)
    p.add_argument("--multihost", action="store_true",
                   help="multi-process sharded solver; " + _NOT_PORTED)
    p.add_argument("--coordinator", default=None,
                   help="coordinator HOST:PORT for --multihost")
    p.add_argument("--num-processes", type=int, default=None,
                   help="process count for --multihost")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's index for --multihost")
    p.add_argument("--checkpoint-dir", default=None,
                   help="persist solver state each accepted step "
                        "(torch.save files and history.json)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in "
                        "--checkpoint-dir")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace of the solve "
                        "(trace.json) into this directory")
    p.add_argument("--jsonl", default=None,
                   help="write per-iteration JSONL records here")
    p.add_argument("--ply", default=None,
                   help="export the optimized point cloud as PLY")
    p.add_argument("--debug-nans", action="store_true",
                   help="sanitizer mode: run the host-driven loop and "
                        "raise FloatingPointError at the first non-finite "
                        "cost, gradient or step")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--full-report", action="store_true")
    return p


def _raise_on_non_finite(fns: dict) -> dict:
    """Phase functions that raise at the first non-finite cost, gradient
    or step (each check reads one flag back, so this is the host loop's
    business only)."""
    import torch

    def check(name, tensors):
        flat = [t for t in tensors if isinstance(t, torch.Tensor)]
        if not all(bool(torch.isfinite(t).all()) for t in flat):
            raise FloatingPointError(f"non-finite {name}")

    prepare, solve_step = fns["prepare"], fns["solve_step"]

    def checked_prepare(p):
        aux = prepare(p)
        check("cost", [aux["cost"]])
        check("gradient", [aux["gradient_max_norm"]])
        return aux

    def checked_solve_step(aux, radius):
        dx, predicted, iters = solve_step(aux, radius)
        check("step", list(dx.values()) if isinstance(dx, dict) else [dx])
        return dx, predicted, iters

    out = dict(fns, prepare=checked_prepare, solve_step=checked_solve_step)
    out.pop("raw", None)
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if (args.shard or args.multihost or args.coordinator is not None
            or args.num_processes is not None
            or args.process_id is not None):
        raise NotImplementedError("--shard / --multihost " + _NOT_PORTED)

    import torch

    from .. import default_device
    from ..problem import synthetic
    from ..solver import lm
    from ..solver.options import SolverOptions

    device = default_device(None if args.device == "cuda" else args.device)
    on_card = device.type == "cuda"
    if args.dtype is None:
        args.dtype = "f32" if on_card else "f64"
    dtype = torch.float32 if args.dtype == "f32" else torch.float64

    t0 = time.perf_counter()
    if args.config:
        ba = synthetic.CONFIGS[args.config](scale=args.scale, seed=args.seed,
                                            dtype=dtype, device=device)
        problem, params0 = ba.problem, ba.params0
        name = args.config
    else:
        from ..io import bal
        problem, params0 = bal.load_bal(args.bal, dtype=dtype, device=device)
        name = args.bal

    solver = (args.linear_solver
              or CONFIG_SOLVER_DEFAULTS.get(args.config or "", "dense_schur"))
    options = SolverOptions(
        linear_solver=solver, preconditioner=args.preconditioner,
        evaluator=args.evaluator,
        trust_region_strategy=args.trust_region_strategy,
        check_gradients=args.check_gradients,
        max_iterations=args.max_iterations,
        max_cg_iterations=args.max_cg_iterations, cg_eta=args.cg_eta,
        function_tolerance=args.function_tolerance, verbose=args.verbose,
        device_loop="off" if args.debug_nans else "auto")

    where = (f"{torch.cuda.get_device_name(device)} "
             f"x{torch.cuda.device_count()}" if on_card else "cpu")
    print(f"[rsba_tpu_torch] problem {name}: "
          f"{int(torch.sum(problem.obs.mask))} observations, "
          f"{params0.n_poses} poses, {params0.n_points} points | "
          f"solver={solver} dtype={args.dtype} device={where}")

    callback = None
    ckpt = None
    resume_summary = None
    if args.checkpoint_dir:
        from ..utils import SolverCheckpointer
        ckpt = SolverCheckpointer(args.checkpoint_dir, options=options)
        callback = ckpt.callback
        if args.resume:
            restored = ckpt.restore(device=device)
            if restored is not None:
                it0, params0, radius = restored
                options = dataclasses.replace(options, initial_radius=radius)
                history = ckpt.restore_history()
                if history:
                    from ..solver.summary import Summary
                    resume_summary = Summary(iterations=history)
                    resume_summary.num_successful_steps = sum(
                        1 for it in history if it.accepted)
                    resume_summary.num_unsuccessful_steps = sum(
                        1 for it in history if not it.accepted)
                    # The true initial cost is the cost before the first
                    # accepted step: a record's cost is the cost after its
                    # step, and adding the step's decrease gives it back.
                    resume_summary.initial_cost = (
                        history[0].cost + history[0].cost_change)
                print(f"[rsba_tpu_torch] resumed from checkpoint step {it0} "
                      f"(radius {radius:.3e}, "
                      f"{len(history)} prior iteration records)")

    fns = None
    if args.debug_nans:
        fns = _raise_on_non_finite(lm.make_solver_fns(problem, options))

    profiler = contextlib.nullcontext()
    if args.profile_dir:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=acts)
    with profiler as prof:
        params, summary = lm.solve(problem, params0, options,
                                   callback=callback, fns=fns,
                                   summary=resume_summary)
        if on_card:
            torch.cuda.synchronize(device)
    if args.profile_dir:
        os.makedirs(args.profile_dir, exist_ok=True)
        trace = os.path.join(args.profile_dir, "trace.json")
        prof.export_chrome_trace(trace)
        print(f"[rsba_tpu_torch] wrote {trace}")
    if ckpt is not None:
        ckpt.wait()
    wall = time.perf_counter() - t0

    if args.full_report:
        print(summary.full_report())
    else:
        print(summary.brief_report())
    print(json.dumps({
        "problem": name, "solver": summary.linear_solver,
        "evaluator": summary.evaluator, "dtype": args.dtype,
        "device": where,
        "termination": summary.termination,
        "final_cost": summary.final_cost,
        "final_rmse_px": summary.final_rmse,
        "final_rmse_inlier_px": summary.final_rmse_inlier,
        "iterations": summary.num_iterations,
        "wall_s": round(wall, 3),
    }))
    if args.jsonl:
        summary.write_jsonl(args.jsonl)
    if args.ply:
        from ..io import bal as bal_io
        bal_io.export_ply(args.ply, params)
        print(f"[rsba_tpu_torch] wrote {args.ply}")
    return 0 if summary.termination in ("CONVERGENCE", "USER_SUCCESS") else 2


if __name__ == "__main__":
    sys.exit(main())
