"""Rank body of tests/test_torch_dist.py's world (imports no jax).

``run_all(mesh, cases)`` runs every scenario of that file on one rank of
a gloo world, on problems that the test process made from the JAX
package's generator (``cases``: name → (Problem, Params), float64, CPU),
and returns numpy results: whole-problem values (all-reduced, or
gathered by ``to_external``) plus the rank's own block where a test
needs it; then the rank body of ``entry.dryrun_multichip``, after the
all-reduce counts are read.
"""
import torch

from rsba_tpu_torch import dist, entry
from rsba_tpu_torch.solver import lm
from rsba_tpu_torch.solver.options import SolverOptions


def _np(x):
    return x.detach().cpu().numpy()


def _seq(summary):
    return "".join("A" if it.accepted else "r" for it in summary.iterations)


def banded_step(mesh, problem, params0):
    """Prepare and one damped step of the banded sharded engine
    (tests/test_distributed.py::test_sharded_banded_matches_single_chip's
    options)."""
    opts = SolverOptions(linear_solver="banded_schur",
                         max_cg_iterations=300, cg_eta=1e-10)
    fns = dist.make_sharded_window_solver_fns(problem, opts, mesh)
    p = fns["to_internal"](params0)
    aux = fns["prepare"](p)
    dx, pred, _ = fns["solve_step"](aux, 1e4)
    pt = fns["to_external"](p.replace(points=dx["pt"])).points
    return {"engine": fns["engine"], "rows": fns["local"]["rows"],
            "cost": float(aux["cost"]),
            "gmax": float(aux["gradient_max_norm"]), "pred": float(pred),
            "pose": _np(dx["pose"]), "pt": _np(pt)}


def solve(mesh, problem, params0, flat_solver=None):
    """A full sharded solve: banded, or the flat engine on the
    repartitioned problem."""
    if flat_solver is None:
        opts = SolverOptions(linear_solver="banded_schur", max_iterations=30)
        fns = dist.make_sharded_window_solver_fns(problem, opts, mesh)
    else:
        problem, params0, _ = dist.repartition_by_point(problem, params0,
                                                        mesh.size)
        opts = SolverOptions(linear_solver=flat_solver, max_iterations=30,
                             max_cg_iterations=200, cg_eta=1e-6)
        fns = dist.make_sharded_solver_fns(problem, opts, mesh)
    params, s = lm.solve(problem, params0, opts, fns=fns)
    return {"engine": (s.linear_solver, s.evaluator),
            "termination": s.termination, "message": s.message,
            "final_rmse": s.final_rmse, "final_cost": s.final_cost,
            "seq": _seq(s), "c": _np(params.c), "points": _np(params.points)}


def flat_step(mesh, problem, params0, solver):
    """Prepare and one damped step of the flat sharded engine on the
    repartitioned problem (test_sharded_prepare_matches_single's
    options); the point step is the rank's chunk."""
    problem, params0, _ = dist.repartition_by_point(problem, params0,
                                                    mesh.size)
    opts = SolverOptions(linear_solver=solver, max_cg_iterations=300,
                         cg_eta=1e-10, refinement_steps=1)
    fns = dist.make_sharded_solver_fns(problem, opts, mesh)
    aux = fns["prepare"](fns["to_internal"](params0))
    step, pred, _ = fns["solve_step"](aux, 1e4)
    return {"engine": fns["engine"], "cost": float(aux["cost"]),
            "gmax": float(aux["gradient_max_norm"]), "pred": float(pred),
            "pose": _np(step["pose"]), "pt_chunk": _np(step["pt"])}


def run_all(mesh, cases):
    out = {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend,
           "banded_step": banded_step(mesh, *cases["banded_step"]),
           "banded_solve": solve(mesh, *cases["banded_solve"]),
           "gs_solve": solve(mesh, *cases["gs"], "iterative_schur")}
    for solver in ("iterative_schur", "dense_schur"):
        out[f"flat_step_{solver}"] = flat_step(mesh, *cases["flat_step"],
                                               solver)
        out[f"flat_solve_{solver}"] = solve(mesh, *cases["flat_solve"],
                                            solver)
    out["all_reduce"] = dict(mesh.counts)
    out["dryrun"] = entry._dryrun_rank(mesh)
    return out


def fail_on_rank(mesh, bad):
    """Rank ``bad`` raises while the others wait in a collective."""
    if mesh.rank == bad:
        raise FloatingPointError("rank failed on purpose")
    mesh.psum(torch.ones(1))
    return mesh.rank
