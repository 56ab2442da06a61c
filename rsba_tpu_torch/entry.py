"""Entry points: one LM iteration on the flagship, and a sharded dry run.

Counterpart of ``__graft_entry__.py``.  ``entry()`` returns one full LM
iteration (fused evaluate + banded-Schur assembly, band-PCG solve,
retraction, re-cost) on a tiny instance of config 4 (rolling-shutter
SLERP, distortion, Huber) through ``linear_solver="auto"``, which
resolves to the banded window solver: on the card its prepare is the
CUDA kernel.

``dryrun_multichip(n)`` starts n ranks (``dist.launch``) and runs one
sharded LM step through both distributed engines, each held to the
single-device step on the same problem with the reference's
tolerances.
"""
from __future__ import annotations

import numpy as np
import torch

from . import default_device
from .geometry import Loss
from .problem import synthetic
from .problem.types import Params
from .solver import lm
from .solver.options import SolverOptions


def _tiny_flagship(dtype=torch.float32, device=None):
    return synthetic.make_ba_problem(
        n_poses=9, n_points=160, track_len=4, rolling_shutter=True,
        rotation_interp="slerp", use_distortion=True,
        loss=Loss("huber", 4.0), pixel_noise=0.4, seed=0, dtype=dtype,
        pad_to=64, device=device)


def entry(device=None):
    """(fn, example_args): one LM iteration on config 4 (tiny) through
    the banded window solver, ``lm_step(params, radius) -> (params,
    (cost, decrease, predicted, cg_iters))``."""
    ba = _tiny_flagship(device=device)
    opts = SolverOptions(linear_solver="auto", max_cg_iterations=25,
                         cg_eta=1e-2)
    fns = lm.make_solver_fns(ba.problem, opts)
    if fns["engine"][0] != "banded_schur":
        raise RuntimeError(f"auto resolved to {fns['engine']}, not the "
                           "banded window solver")

    def lm_step(params: Params, radius):
        params = fns["to_internal"](params)
        aux = fns["prepare"](params)
        dx, predicted, cg_iters = fns["solve_step"](aux, radius)
        cand, _, _ = fns["apply_step"](params, dx)
        decrease = fns["cost_decrease"](params, cand)
        accept = decrease / predicted > opts.min_relative_decrease
        out = Params(*(torch.where(accept, getattr(cand, f),
                                   getattr(params, f))
                       for f in ("q", "c", "intr", "points")))
        return fns["to_external"](out), (aux["cost"], decrease, predicted,
                                         cg_iters)

    radius = torch.tensor(1e4, dtype=ba.params0.dtype,
                          device=ba.params0.device)
    return lm_step, (ba.params0, radius)


def _close(name, got, want, rtol, atol=0.0):
    np.testing.assert_allclose(
        np.asarray(torch.as_tensor(got).detach().cpu()),
        np.asarray(torch.as_tensor(want).detach().cpu()), rtol=rtol,
        atol=atol, err_msg=name)


def _dryrun_rank(mesh) -> dict:
    """One sharded step of both engines on this rank, against the
    single-device step; returns the rank's scalars."""
    from . import dist
    ba = _tiny_flagship(device=mesh.device)
    radius = torch.tensor(1e4, dtype=ba.params0.dtype, device=mesh.device)
    out = {"rank": mesh.rank, "device": str(mesh.device),
           "backend": mesh.backend}

    # Banded window solver, row-sharded (the config-5 path); the oracle is
    # the single-device banded step on the same problem.
    opts_b = SolverOptions(linear_solver="banded_schur",
                           max_cg_iterations=50, cg_eta=1e-6)
    fns_b = dist.make_sharded_window_solver_fns(ba.problem, opts_b, mesh)
    fns_1 = lm.make_solver_fns(ba.problem, opts_b)
    params_b = fns_b["to_internal"](ba.params0)
    params_1 = fns_1["to_internal"](ba.params0)
    aux = fns_b["prepare"](params_b)
    aux_1 = fns_1["prepare"](params_1)
    _close("banded cost", aux["cost"], aux_1["cost"], 1e-5)
    _close("banded gradient", aux["gradient_max_norm"],
           aux_1["gradient_max_norm"], 1e-4)
    dx, predicted, _ = fns_b["solve_step"](aux, radius)
    dx_1, predicted_1, _ = fns_1["solve_step"](aux_1, radius)
    _close("banded predicted", predicted, predicted_1, 1e-2)
    # float32 + CG: the reduction order shifts the iterate at the ~1e-5
    # level; the oracle is "same step", not equal bits.
    _close("banded pose step", dx["pose"], dx_1["pose"], 5e-2, 2e-4)
    # the point steps compared in the external (M, 3) order
    _close("banded point step",
           fns_b["to_external"](params_b.replace(points=dx["pt"])).points,
           fns_1["to_external"](params_1.replace(points=dx_1["pt"])).points,
           5e-2, 2e-4)
    new_params, _, _ = fns_b["apply_step"](params_b, dx)
    new_cost = float(fns_b["cost"](new_params))
    if not new_cost < float(aux["cost"]):
        raise AssertionError("sharded banded LM step did not decrease cost")
    out.update(engine_banded=fns_b["engine"], cost=float(aux["cost"]),
               banded_new_cost=new_cost)

    # Flat iterative Schur, landmark-sharded, against the single-device
    # engine on the repartitioned problem.
    prob2, params2, _ = dist.repartition_by_point(ba.problem, ba.params0,
                                                  n_shards=mesh.size)
    opts = SolverOptions(linear_solver="iterative_schur",
                         preconditioner="schur_jacobi",
                         max_cg_iterations=50, cg_eta=1e-6)
    fns = dist.make_sharded_solver_fns(prob2, opts, mesh)
    fns_f1 = lm.make_solver_fns(prob2, opts)
    params_s = fns["to_internal"](params2)
    aux = fns["prepare"](params_s)
    aux_f1 = fns_f1["prepare"](params2)
    _close("flat cost", aux["cost"], aux_f1["cost"], 1e-5)
    _close("flat gradient", aux["gradient_max_norm"],
           aux_f1["gradient_max_norm"], 1e-4)
    step, predicted, _ = fns["solve_step"](aux, radius)
    dx_f1, predicted_f1, _ = fns_f1["solve_step"](aux_f1, radius)
    _close("flat predicted", predicted, predicted_f1, 1e-2)
    d_pose1, _, d_pt1 = lm.assembly.unflatten_tangent(
        dx_f1, lm.assembly.tangent_shapes(prob2, params2))
    m = params_s.n_points
    _close("flat pose step", step["pose"], d_pose1, 5e-2, 2e-4)
    _close("flat point step", step["pt"],
           d_pt1[mesh.rank * m:(mesh.rank + 1) * m], 5e-2, 2e-4)
    new_params, _, _ = fns["apply_step"](params_s, step)
    new_cost = float(fns["cost"](new_params))
    if not new_cost < float(aux["cost"]):
        raise AssertionError("sharded flat LM step did not decrease cost")
    out.update(engine_flat=fns["engine"], flat_new_cost=new_cost)
    return out


def dryrun_multichip(n_devices: int, backend=None, device=None) -> list:
    """One sharded LM step on ``n_devices`` ranks (tiny shapes) through
    both distributed engines:

    1. the banded window solver split along the trajectory's window rows
       (``dist.banded_sharded``, the config-5 path: one band all-reduce
       per step, CG without collectives), and
    2. the flat iterative-Schur solver split by landmark ownership
       (``dist.sharded``, one all-reduce per CG matvec).

    Each rank holds both to the single-device step (cost, gradient,
    predicted decrease and the step itself) and raises if they differ;
    returns the ranks' scalars.  ``backend`` and ``device`` as in
    ``dist.launch.spawn``: the card and NCCL by default.
    """
    from .dist import launch
    return launch.spawn(_dryrun_rank, n_devices, backend,
                        default_device(device))
