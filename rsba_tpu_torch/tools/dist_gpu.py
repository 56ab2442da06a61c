"""Solve a config through the sharded engines over N ranks on this host.

    python3 -m rsba_tpu_torch.tools.dist_gpu --config rs_mhost_pcg \\
        --ranks 2 --backend gloo

Each rank generates the config from its seed on its device, keeps the
whole problem on the host, builds the sharded engine as the CLI does
(``dist.make_solver_fns``; ``--solver auto``: the banded window solver,
else the flat ``iterative_schur``) and solves it through ``lm.solve``'s
host loop.  It reports, per rank, the engine, the termination, the
inlier RMSE, the accept sequence, the solve wall, the fused kernel's
launches against the prepares, the all-reduces with their bytes, and ``torch.cuda.max_memory_allocated``
from the solve; then one JSON line with all ranks.  With one card,
``--backend gloo`` puts every rank on it (functional only: the ranks
share the card, so no time here is a scaling number); ``nccl`` needs one
card per rank.  ``--device cpu`` runs the ranks on the CPU (gloo).

``solve_rank`` is the rank's body; ``chip_smoke.py`` runs it as well.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def solve_rank(mesh, job: dict) -> dict:
    """Generate ``job["config"]`` on this rank's device and solve it
    sharded; returns the rank's record.  ``job``: config, scale, seed,
    dtype ("f32"/"f64"), solver ("auto" or a flat sharded solver),
    max_iterations, and ``kernel_rows`` (also return the fused kernel's
    seven outputs at the initial parameters for this rank's rows, on the
    CPU, for a comparison with a one-process launch)."""
    import torch

    from .. import dist
    from ..kernels import fused
    from ..problem import synthetic
    from ..problem.types import params_from_numpy, problem_from_numpy
    from ..solver import banded_fused, lm
    from ..solver.options import SolverOptions

    dev = mesh.device
    on_card = dev.type == "cuda"
    dtype = torch.float32 if job.get("dtype", "f32") == "f32" \
        else torch.float64
    t0 = time.perf_counter()
    ba = synthetic.CONFIGS[job["config"]](scale=job.get("scale", 1.0),
                                          seed=job.get("seed", 0),
                                          dtype=dtype, device=dev)
    problem = problem_from_numpy(ba.problem, device="cpu", dtype=dtype)
    params0 = params_from_numpy(ba.params0, device="cpu", dtype=dtype)
    del ba
    if on_card:
        torch.cuda.empty_cache()
    t_gen = time.perf_counter() - t0

    options = SolverOptions(linear_solver=job.get("solver", "auto"),
                            max_iterations=job.get("max_iterations", 60))
    t0 = time.perf_counter()
    fns, problem, params0, options, _ = dist.make_solver_fns(
        problem, params0, options, mesh)
    t_build = time.perf_counter() - t0

    rec = {"rank": mesh.rank, "ranks": mesh.size, "backend": mesh.backend,
           "device": str(dev), "config": job["config"]}
    if job.get("kernel_rows"):
        loc = fns["local"]
        inp = banded_fused.kernel_inputs(
            fns["to_internal"](params0), loc["plan"], loc["problem"],
            banded_fused.kernel_statics(loc["plan"], loc["problem"]))
        out = fused.fused_evaluate_assemble_cuda(
            *inp, model=problem.model, loss=problem.loss)
        rec["rows"] = loc["rows"]
        rec["kernel_out"] = {k: v.cpu() for k, v in out.items()
                             if k != "cost"}

    prepares = [0]
    inner = fns["prepare"]

    def counted_prepare(p):
        prepares[0] += 1
        return inner(p)

    fns = dict(fns, prepare=counted_prepare)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    fused.fused_evaluate_assemble_cuda.launches = 0
    mesh.counts.update(all_reduce=0, bytes=0)
    t0 = time.perf_counter()
    params, s = lm.solve(problem, params0, options, fns=fns)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    attempts = max(s.num_iterations, 1)
    rec.update(
        engine=f"{s.linear_solver}/{s.evaluator}", termination=s.termination,
        message=s.message, iterations=s.num_iterations,
        accepted=s.num_successful_steps,
        seq="".join("A" if it.accepted else "r" for it in s.iterations),
        cg=sum(it.linear_solver_iterations for it in s.iterations),
        final_cost=s.final_cost, rmse_inlier=s.final_rmse_inlier,
        wall_s=wall, generate_s=t_gen, build_s=t_build,
        prepares=prepares[0],
        kernel_launches=fused.fused_evaluate_assemble_cuda.launches,
        all_reduces=mesh.counts["all_reduce"],
        all_reduce_bytes=mesh.counts["bytes"],
        all_reduce_bytes_per_attempt=mesh.counts["bytes"] / attempts,
        max_memory_gib=(torch.cuda.max_memory_allocated(dev) / 2**30
                        if on_card else None),
        finite=bool(all(torch.isfinite(getattr(params, f)).all()
                        for f in ("q", "c", "intr", "points"))))
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="rsba_tpu_torch.tools.dist_gpu",
                                description=__doc__.split("\n")[0])
    p.add_argument("--config", default="rs_mhost_pcg")
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                   help="default: nccl on the card, gloo on the CPU")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    p.add_argument("--solver", default="auto",
                   choices=["auto", "banded_schur", "iterative_schur",
                            "dense_schur"])
    p.add_argument("--max-iterations", type=int, default=60)
    args = p.parse_args(argv)

    from ..dist import launch
    job = {"config": args.config, "scale": args.scale, "seed": args.seed,
           "dtype": args.dtype, "solver": args.solver,
           "max_iterations": args.max_iterations}
    t0 = time.perf_counter()
    recs = launch.spawn(solve_rank, args.ranks, args.backend, args.device,
                        job)
    total = time.perf_counter() - t0
    for r in recs:
        mem = ("-" if r["max_memory_gib"] is None
               else f"{r['max_memory_gib']:.3f} GiB")
        print(f"rank {r['rank']}/{r['ranks']} ({r['backend']}, "
              f"{r['device']}): {r['engine']}, {r['termination']} in "
              f"{r['iterations']} attempts {r['seq']}, inlier RMSE "
              f"{r['rmse_inlier']:.5f} px, solve {r['wall_s']:.3f} s "
              f"(generate {r['generate_s']:.2f} s, engine build "
              f"{r['build_s']:.2f} s), prepares {r['prepares']}, kernel "
              f"launches {r['kernel_launches']}, all-reduces "
              f"{r['all_reduces']} ({r['all_reduce_bytes_per_attempt']:.0f} "
              f"B an attempt), max memory {mem}", flush=True)
    same = len({(r["seq"], r["final_cost"]) for r in recs}) == 1
    print(json.dumps({"dist_gpu": recs, "ranks_agree": same,
                      "total_s": total}))
    ok = same and all(r["termination"] == "CONVERGENCE" and r["finite"]
                      for r in recs)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
