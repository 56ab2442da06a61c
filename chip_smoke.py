#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rsba_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

Phases, each raising on failure (exit code 1):

1. environment: the card's name and power limit, the torch / CUDA / nvcc
   / Triton versions, and the build of the CUDA kernels from csrc/ with
   what ptxas reports for each entry (registers, spills);
2. the fused evaluate+assemble kernel against its plain PyTorch version
   on the card: six small float64 fixtures covering every
   specialisation, one of them again with pose_b == pose_a on part of
   its slots, one again as a bucketed session's windowed BA poses it
   (constant poses, dummy poses and points that no observation touches),
   and one whose rows are too wide for one shared-memory tile
   so that the kernel walks them in column chunks (rtol = atol = 1e-9);
   then config 4's shapes in float32 (each output within 1e-4·max|ref|,
   summation order over ~L·G terms), two launches on the same inputs
   giving equal bits, the kernel's bound from the shapes, and the
   kernel's and the plain version's times;
3. config 4 (rs_slerp_robust, 1,001 poses, 100k points) at full size in
   float32 through ``rsba_tpu_torch.solver.solve`` with the default
   options, which is the on-device loop replayed from CUDA graphs: the
   engine must be banded_schur/cuda+device_loop, every prepare must
   launch the kernel (a graph replay counts the launches it holds), the
   host must read back no more than one tensor per attempt and block,
   and the solve must converge to within 0.002 px of the float64
   inlier-RMSE anchor; a second solve on the same graphs must take the
   same accept/reject sequence; then the same problem through the host
   loop (``device_loop="off"``), with both walls side by side;
4. config 3 (rs_video_linear) at full size through the loop, and once
   more with ``preconditioner="cluster_jacobi"``;
5. config 1 (gs_small, ``dense``, then dogleg through ``dense`` and
   through ``dense_schur``) and config 2 (gs_bal, ``dense_schur``, then
   dogleg through ``dense_schur``) at full size in float32, to their
   anchors; each dogleg solve must end in CONVERGENCE within
   ``DOGLEG_MAX_ATTEMPTS`` attempts, accepted and rejected, and prints
   the Gauss-Newton radius and the solves of each prepare; then config 1
   at scales 0.1 and 0.2 through the dogleg and both engines, float32
   against float64 on the card, to the same limit;
6. covariance and gradient check on config 1's solution with two poses
   pinned: the camera covariance of the float32 problem (which
   ``compute_covariance`` estimates in float64) symmetric and positive
   definite on its free block and within 1e-3 of a float64 dense inverse
   of the whole Gauss-Newton matrix computed on the card (max |Δ| over
   max |ref|), and ``check_gradients`` in float32 at the solver's float32
   default of 2e-3 and in float64 at 1e-5; then a float32 solve of config
   1 with ``check_gradients=True`` at that default, which must pass and
   converge, and a Jacobian with J_pt scaled by 1.01, which the float32
   check must refuse at 2e-3;
7. the video-SfM session at the size of ``benchmarks/pipeline_tpu.py``
   (50 frames, 1,200 points, float32, window 8, a BA every 4 frames,
   shape buckets) through ``rsba_tpu_torch.tools.pipeline_gpu``: every
   frame registered, the final full BA ``CONVERGENCE`` under 1.25 px
   through ``banded_schur/cuda...``, the steady state's windowed BAs
   through the same engine (any that were not are printed), the kernel's
   launches counted from 0, and the kernel held against its plain
   version on that session's own last windowed and full BA problems
   (bucketed shapes; float32 at 1e-4·max|ref|, the two gradients, which
   cancel at the solution, within that plus four times the plain
   version's own float32 round-off, equal bits from two launches; the
   same problems in float64 at 1e-8·max|ref|); then the same session
   with ``device_loop="off"``;
8. RANSAC registration without a prior: 2,000 matches, 40% outliers, 256
   hypotheses, float32, held to the true inlier set within 2% and to the
   pose envelope of ``tests/test_registration.py``;
9. the CLI in-process: ``--config rs_video_linear`` to its anchor, and a
   checkpointed run resumed from its directory, whose history continues;
10. the distributed solvers (``rsba_tpu_torch.dist``), functional only on
   one card: ``entry()``'s LM step through the kernel;
   ``dryrun_multichip(1)`` on NCCL and ``dryrun_multichip(2,
   backend="gloo")`` with both ranks on the card; config 4 in float32
   through the banded sharded engine (``cuda-sharded``) on a world of one
   rank on NCCL, which must take phase 3's host-loop accept sequence, and
   on two gloo ranks sharing the card, which must reach the anchor with
   equal records on both ranks and whose kernel outputs must equal the
   one-process launch's rows in every bit; config 1 on two gloo ranks
   through the flat ``iterative_schur`` and ``dense_schur``; the CLI's
   ``--shard`` on config 3.  Each kernel launch count there is read from
   0 around its solve, one launch per prepare on every rank;
11. self-calibration of one camera shared by every frame: config 1 at
   full size in float32 with its intrinsics block freed through
   ``intr_basis_subset([0, 2, 3], tie_focal=True)`` (focal, cx, cy) and
   started at fx, fy x 1.01, cx + 2 px, cy - 2 px; solved through the
   default options, which must resolve to the flat ``iterative_schur``
   on the captured loop, and through ``dense_schur``, each to
   ``CONVERGENCE``, the inlier-RMSE anchor and a focal within 2 px of
   the float64 solution, with a float64 ``dense_schur`` solve on the card
   beside them; then phase 6's covariance and gradient check at the
   ``dense_schur`` solution, its intrinsics block included.  The flat
   engines' prepare is ``residuals.evaluate``: this phase launches no
   kernel of csrc/, and holds it to 0 launches.

The last two lines are a JSON record of the kernels and the result line
``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits non-zero before printing any result.
"""
from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import tempfile
import time

# float64 CPU anchors of the final inlier RMSE (px),
# benchmarks/baselines/cpu_config4.json and ROADMAP.md.
RMSE_ANCHOR = {"rs_slerp_robust": 0.79695, "rs_video_linear": 0.65990,
               "gs_small": 0.63709, "gs_bal": 0.64874,
               # phase 11's problem, solved in float64 through dense_schur
               # from its perturbed start by rsba_tpu and by this port on
               # the CPU: 0.6370930 px in both, focal 900.2078
               "gs_small_selfcal": 0.63709}
SELFCAL_FOCAL_F64 = 900.208
RMSE_TOL = 0.002
DOGLEG_MAX_ATTEMPTS = 12      # float64 takes 3 to 4 on config 1
N_OBS_CONFIG4 = 910092        # benchmarks/SCALING.json, float64 generator
KERNEL_SOURCE = "rsba_tpu_torch/csrc/fused_evaluate_assemble.cu"
KERNEL_REPLACES = "rsba_tpu/kernels/fused.py:469"
PIXEL_NOISE = 0.5             # of every synthetic sequence here


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


def fixtures():
    """Small float64 problems, one per kernel specialisation."""
    from rsba_tpu_torch.geometry import Loss
    return {
        # tests/test_fused_kernel.py fixtures
        "rs_slerp_huber": dict(
            n_poses=9, n_points=80, track_len=3, rolling_shutter=True,
            rotation_interp="slerp", use_distortion=False,
            loss=Loss("huber", 4.0), seed=3, pad_to=32),
        "rs_nlerp": dict(
            n_poses=9, n_points=64, track_len=3, rolling_shutter=True,
            rotation_interp="nlerp", use_distortion=False, seed=5,
            pad_to=32),
        "gs_distortion": dict(
            n_poses=9, n_points=64, track_len=3, rolling_shutter=False,
            use_distortion=True, seed=4, pad_to=32),
        # __graft_entry__._tiny_flagship's shape
        "flagship_slerp_dist_huber": dict(
            n_poses=9, n_points=160, track_len=4, rolling_shutter=True,
            rotation_interp="slerp", use_distortion=True,
            loss=Loss("huber", 4.0), pixel_noise=0.4, seed=0, pad_to=64),
        "rs_lerp_aa_cauchy": dict(
            n_poses=9, n_points=80, track_len=3, rolling_shutter=True,
            rotation_interp="lerp_aa", use_distortion=True,
            loss=Loss("cauchy", 2.0), outlier_fraction=0.1, seed=7,
            pad_to=32),
        "rs_slerp_soft_l1": dict(
            n_poses=9, n_points=80, track_len=3, rolling_shutter=True,
            rotation_interp="slerp", use_distortion=True,
            loss=Loss("soft_l1", 2.0), outlier_fraction=0.1, seed=8,
            pad_to=32),
    }


def chunked_fixture():
    """A float64 problem whose rows (G = 352 columns, W = 5) are wider
    than one block's shared-memory tile of F: the chunked route."""
    from rsba_tpu_torch.geometry import Loss
    return dict(n_poses=9, n_points=1500, track_len=4, rolling_shutter=True,
                rotation_interp="slerp", use_distortion=True,
                loss=Loss("huber", 4.0), seed=11, pad_to=64)


def session_shaped(ba, n_fixed=4, dummy_poses=3, dummy_points=40):
    """The problem as a bucketed session's windowed BA poses it: the
    first poses constant, and constant dummy poses and points behind the
    real ones that no observation touches (rows with zero contributors)."""
    import dataclasses
    import torch
    pr, x = ba.problem, ba.params0
    cat = lambda a, b: torch.cat([a, b.to(a)])  # noqa: E731
    pose_free = pr.pose_free.clone()
    pose_free[:n_fixed] = 0.0
    seen_free = torch.zeros_like(pr.point_free)
    free_obs = (pose_free[pr.obs.pose_a.long()] > 0) & (pr.obs.mask > 0)
    seen_free[pr.obs.point.long()[free_obs]] = 1.0
    ident = torch.tensor([[1.0, 0.0, 0.0, 0.0]]).repeat(dummy_poses, 1)
    problem = pr.replace(
        pose_free=cat(pose_free, torch.zeros(dummy_poses)),
        point_free=cat(seen_free, torch.zeros(dummy_points)))
    params = x.replace(q=cat(x.q, ident),
                       c=cat(x.c, torch.zeros(dummy_poses, 3)),
                       points=cat(x.points, torch.ones(dummy_points, 3)))
    return dataclasses.replace(ba, problem=problem, params0=params)


def same_pose_on_some_slots(inp):
    """The kernel inputs with pose_b == pose_a (rsf = 0) on every third
    point column: the route where both sides of a slot move one pose."""
    inp = list(inp)
    rsf = inp[7].clone()
    rsf[:, :, ::3] = 0.0
    inp[7] = rsf
    return tuple(inp)


def kernel_inputs(ba):
    """(plan, statics, planes params, kernel inputs) of a problem."""
    from rsba_tpu_torch.solver import banded_fused, window
    plan = window.build_window_plan(ba.problem)
    statics = banded_fused.kernel_statics(plan, ba.problem)
    params = banded_fused.to_internal(ba.params0, plan)
    return plan, statics, params, banded_fused.kernel_inputs(
        params, plan, ba.problem, statics)


def compare(name, ba, rtol=None, atol=None, rel_to_max=None, edit=None,
            cancelling=()):
    """Kernel vs plain version on one problem (``edit`` maps the kernel
    inputs to the ones both versions get); returns max |Δ|.  An output
    named in ``cancelling`` is a sum whose terms cancel at these
    parameters (a gradient at a solution): its limit is widened by four
    times the plain version's own round-off, which is its distance from
    the plain version on the same inputs in float64."""
    import torch
    from rsba_tpu_torch.kernels import fused
    plan, _, _, inp = kernel_inputs(ba)
    if edit is not None:
        inp = edit(inp)
    model, loss = ba.problem.model, ba.problem.loss
    ref = fused.fused_evaluate_assemble_reference(*inp, model=model,
                                                  loss=loss)
    roundoff = {}
    if cancelling:
        exact = fused.fused_evaluate_assemble_reference(
            *(x.double() if torch.is_tensor(x) and x.is_floating_point()
              else x for x in inp), model=model, loss=loss)
        roundoff = {k: float((ref[k] - exact[k]).abs().max())
                    for k in cancelling}
        del exact
    out = fused.fused_evaluate_assemble_cuda(*inp, model=model, loss=loss)
    torch.cuda.synchronize()
    worst_abs, worst_rel = 0.0, 0.0
    for k, r in ref.items():
        o = out[k]
        if o.shape != r.shape or not torch.isfinite(o).all():
            raise AssertionError(f"{name}: {k} shape {tuple(o.shape)} vs "
                                 f"{tuple(r.shape)} or non-finite")
        d = (o - r).abs()
        scale = float(r.abs().max())
        err = float(d.max())
        worst_abs = max(worst_abs, err)
        worst_rel = max(worst_rel, err / max(scale, 1e-300))
        if rel_to_max is not None:
            ok = err <= rel_to_max * scale + 4.0 * roundoff.get(k, 0.0)
            if k in roundoff:
                log(f"  {name}: {k} max|Δ| {err:.3e} at max|ref| "
                    f"{scale:.3e}; the plain version's float32 round-off "
                    f"{roundoff[k]:.3e}")
        else:
            ok = bool((d <= atol + rtol * r.abs()).all())
        if not ok:
            raise AssertionError(f"{name}: kernel output {k} differs from "
                                 f"the plain version: max|Δ| {err:.3e}, "
                                 f"max|ref| {scale:.3e}")
    lp = fused.launch_plan(plan.W, plan.G, inp[0].element_size(),
                           model.rolling_shutter)
    log(f"kernel vs plain {name} ({str(inp[0].dtype)[6:]}, NR={plan.NR} "
        f"W={plan.W} L={plan.L} G={plan.G}, {lp.threads} threads, "
        f"{lp.chunks} chunk(s) of {lp.tile_cols} columns, "
        f"{lp.smem_bytes} B shared): max|Δ| {worst_abs:.3e}, "
        f"max |Δ|/max|ref| {worst_rel:.3e}  OK")
    return worst_abs


def check_equal_bits(ba):
    """Two launches on the same inputs must give the same bits."""
    import torch
    from rsba_tpu_torch.kernels import fused
    _, _, _, inp = kernel_inputs(ba)
    model, loss = ba.problem.model, ba.problem.loss
    first = fused.fused_evaluate_assemble_cuda(*inp, model=model, loss=loss)
    second = fused.fused_evaluate_assemble_cuda(*inp, model=model, loss=loss)
    torch.cuda.synchronize()
    for k, x in first.items():
        if not torch.equal(x, second[k]):
            raise AssertionError(f"two launches on the same inputs differ "
                                 f"in {k}")
    log(f"two launches on the same {ba.name or 'fixture'} inputs: all seven "
        "outputs torch.equal  OK")


def time_prepares(ba, n_kernel=20, n_plain=3):
    """CUDA-event times (ms) of the kernel alone, the plain version alone,
    and the whole prepare with each, at the problem's shapes; measured in
    turns plain, kernel, kernel, plain."""
    import torch
    from rsba_tpu_torch.kernels import fused
    from rsba_tpu_torch.solver import SolverOptions, banded_fused
    plan, statics, params, inp = kernel_inputs(ba)
    model, loss = ba.problem.model, ba.problem.loss
    opts = SolverOptions()
    fns = {
        "kernel": lambda: fused.fused_evaluate_assemble_cuda(
            *inp, model=model, loss=loss),
        "plain": lambda: fused.fused_evaluate_assemble_reference(
            *inp, model=model, loss=loss),
        "prepare_kernel": lambda: banded_fused.prepare(
            plan, ba.problem, opts, params,
            fused.fused_evaluate_assemble_cuda, statics),
        "prepare_plain": lambda: banded_fused.prepare(
            plan, ba.problem, opts, params,
            fused.fused_evaluate_assemble_reference, statics),
    }

    def timed(f, n):
        f()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            f()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / n

    t = {}
    for kind in ("", "prepare_"):
        p1 = timed(fns[kind + "plain"], n_plain)
        k1 = timed(fns[kind + "kernel"], n_kernel)
        k2 = timed(fns[kind + "kernel"], n_kernel)
        p2 = timed(fns[kind + "plain"], n_plain)
        t[kind + "kernel"] = 0.5 * (k1 + k2)
        t[kind + "plain"] = 0.5 * (p1 + p2)
        log(f"time {kind or 'kernel-only '}at config-4 shapes (float32): "
            f"kernel {k1:.3f} / {k2:.3f} ms, plain {p1:.3f} / {p2:.3f} ms")
    return t


def solve_config(name, card, tag, ba=None, fns=None, **option_kw):
    """Full-size float32 solve through the port's public entry point,
    held to its engine, its termination and its RMSE anchor.  Returns a
    dict with the problem, the phase functions, the Summary, the kernel
    launches and the wall time."""
    import torch
    from rsba_tpu_torch.kernels import fused
    from rsba_tpu_torch.problem import synthetic
    from rsba_tpu_torch.solver import SolverOptions, make_solver_fns, solve

    opts = SolverOptions(max_iterations=60, **option_kw)
    if ba is None:
        t0 = time.perf_counter()
        ba = synthetic.CONFIGS[name](scale=1.0, dtype=torch.float32,
                                     device="cuda")
        torch.cuda.synchronize()
        log(f"{name} [{card}]: n_obs {int(ba.problem.obs.mask.sum())}, poses "
            f"{ba.problem.pose_free.numel()}, points "
            f"{ba.problem.point_free.numel()}, generate "
            f"{time.perf_counter() - t0:.2f} s")
    if fns is None:
        t0 = time.perf_counter()
        fns = make_solver_fns(ba.problem, opts)
        log(f"{name} {tag} [{card}]: plan+engine build "
            f"{time.perf_counter() - t0:.2f} s")
    looped = opts.device_loop != "off" and "raw" in fns
    banded = fns["engine"][0] == "banded_schur"
    prepares = [0]
    if looped:
        # The loop's runner counts its own prepares (block entries,
        # re-prepares and the warm-up before a capture).
        count_prepares = lambda: sum(  # noqa: E731
            r.prepares for r in fns.get("_device_runners", {}).values())
    else:
        inner = fns["prepare"]

        def counted_prepare(p):
            prepares[0] += 1
            return inner(p)

        fns = dict(fns, prepare=counted_prepare)
        count_prepares = lambda: prepares[0]  # noqa: E731
    before = count_prepares()
    torch.cuda.reset_peak_memory_stats()
    fused.fused_evaluate_assemble_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, s = solve(ba.problem, ba.params0, opts, fns=fns)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused.fused_evaluate_assemble_cuda.launches
    n_prep = count_prepares() - before
    mem = torch.cuda.max_memory_allocated()
    seq = "".join("A" if it.accepted else "r" for it in s.iterations)
    cg = sum(it.linear_solver_iterations for it in s.iterations)
    log(f"{name} {tag} [{card}]: engine {s.linear_solver}/{s.evaluator}, "
        f"{s.termination} ({s.message}), valid attempts {s.num_iterations} "
        f"({s.num_successful_steps} accepted) {seq}, CG iterations {cg}, "
        f"prepares {n_prep}, kernel launches {launches}, host read-backs "
        f"{s.host_reads}")
    log(f"{name} {tag} [{card}]: cost {s.initial_cost:.6e} -> "
        f"{s.final_cost:.6e}, inlier RMSE {s.final_rmse_inlier:.5f} px "
        f"(anchor {RMSE_ANCHOR[name]}), solve wall {wall:.3f} s, evaluation "
        f"{s.evaluation_time:.3f} s, linear solver "
        f"{s.linear_solver_time:.3f} s, max_memory_allocated "
        f"{mem / 2**30:.3f} GiB")

    want = ("cuda" if banded else "torch-flat"
            + ("-dogleg" if opts.trust_region_strategy == "dogleg" else ""))
    want += "+device_loop" if looped else ""
    if s.evaluator != want:
        raise AssertionError(f"{name} {tag}: evaluator {s.evaluator}, want "
                             f"{want}")
    if banded and not (launches > 0 and launches == n_prep):
        raise AssertionError(f"{name} {tag}: {launches} kernel launches for "
                             f"{n_prep} prepares")
    if looped:
        blocks = 1
        # One tensor per attempt (invalid attempts leave no record, and one
        # attempt may follow a termination that a prepare set) and one per
        # block.
        invalid = max(n_prep - s.num_successful_steps, 0)
        budget = s.num_iterations + invalid + blocks + 1
        if not 0 < s.host_reads <= budget:
            raise AssertionError(f"{name} {tag}: {s.host_reads} host "
                                 f"read-backs, budget {budget}")
    if s.termination != "CONVERGENCE":
        raise AssertionError(f"{name} {tag}: {s.termination} ({s.message})")
    if abs(s.final_rmse_inlier - RMSE_ANCHOR[name]) > RMSE_TOL:
        raise AssertionError(f"{name} {tag}: inlier RMSE "
                             f"{s.final_rmse_inlier} not within {RMSE_TOL} "
                             f"of {RMSE_ANCHOR[name]}")
    for f in ("q", "c", "intr", "points"):
        x = getattr(params, f)
        if not torch.isfinite(x).all():
            raise AssertionError(f"{name} {tag}: non-finite {f}")
        if tuple(x.shape) != tuple(getattr(ba.params0, f).shape):
            raise AssertionError(f"{name} {tag}: {f} shape {x.shape}")
    return {"ba": ba, "fns": fns, "summary": s, "params": params,
            "launches": launches,
            "wall": wall, "seq": seq, "cg": cg,
            "n_obs": int(ba.problem.obs.mask.sum())}


def dogleg_prepares(problem, opts):
    """The dogleg's phase functions with ``prepare`` recording the
    Gauss-Newton radius 1/μ that each Jacobian's point was solved at, the
    solves it took (1 + retries) and its wall in ms (synchronised; the
    loop reads the cost right after a prepare anyway)."""
    import torch
    from rsba_tpu_torch.solver import make_solver_fns
    fns = make_solver_fns(problem, opts)
    inner, radii, solves, ms = fns["prepare"], [], [], []

    def prepare(params):
        t0 = time.perf_counter()
        aux = inner(params)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        radii.append(aux["gn_radius"])
        solves.append(aux["gn_solves"])
        return aux

    fns["prepare"] = prepare
    return fns, {"radii": radii, "solves": solves, "ms": ms}


def prepares_line(rec) -> str:
    return (f"Gauss-Newton radii {[f'{x:.3g}' for x in rec['radii']]}, "
            f"solves {rec['solves']} ({sum(rec['solves'])} for "
            f"{len(rec['solves'])} prepares), prepare ms "
            f"{[round(x, 1) for x in rec['ms']]}")


def dogleg_config(name, card, tag, ba, linear_solver):
    """A float32 dogleg solve through ``solve_config``, which must also
    end within ``DOGLEG_MAX_ATTEMPTS`` attempts; prints the Gauss-Newton
    radius and the solves of each prepare."""
    from rsba_tpu_torch.solver import SolverOptions
    kw = dict(linear_solver=linear_solver, trust_region_strategy="dogleg")
    fns, rec = dogleg_prepares(ba.problem,
                               SolverOptions(max_iterations=60, **kw))
    r = solve_config(name, card, tag, ba=ba, fns=fns, **kw)
    s = r["summary"]
    log(f"{name} {tag} [{card}]: dogleg {s.termination}, "
        f"{s.num_iterations} attempts ({s.num_successful_steps} accepted), "
        f"inlier RMSE {s.final_rmse_inlier:.5f} px against the float64 "
        f"anchor {RMSE_ANCHOR[name]}, wall {r['wall']:.3f} s, "
        f"{prepares_line(rec)}: {s.message}")
    if s.num_iterations > DOGLEG_MAX_ATTEMPTS:
        raise AssertionError(f"{name} {tag}: {s.num_iterations} attempts, "
                             f"limit {DOGLEG_MAX_ATTEMPTS}")
    return r


def dogleg_scales(card):
    """Config 1 at scales 0.1 and 0.2 through the dogleg, float32 against
    float64 on the card, both engines: each float32 solve must end in
    CONVERGENCE within ``DOGLEG_MAX_ATTEMPTS`` attempts, at the float64
    RMSE ± ``RMSE_TOL``."""
    import torch
    from rsba_tpu_torch.problem import synthetic
    from rsba_tpu_torch.solver import SolverOptions, solve
    for scale in (0.1, 0.2):
        for solver in ("dense", "dense_schur"):
            opts = SolverOptions(linear_solver=solver, max_iterations=50,
                                 trust_region_strategy="dogleg")
            out = {}
            for dt in (torch.float64, torch.float32):
                ba = synthetic.CONFIGS["gs_small"](scale=scale, seed=0,
                                                   dtype=dt, device="cuda")
                fns, rec = dogleg_prepares(ba.problem, opts)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, s = solve(ba.problem, ba.params0, opts, fns=fns)
                torch.cuda.synchronize()
                out[dt] = s
                seq = "".join("A" if it.accepted else "r"
                              for it in s.iterations)
                log(f"gs_small scale {scale} {solver}+dogleg "
                    f"{str(dt)[6:]} [{card}]: {s.termination}, "
                    f"{s.num_iterations} attempts {seq}, inlier RMSE "
                    f"{s.final_rmse_inlier:.5f} px, wall "
                    f"{time.perf_counter() - t0:.3f} s, {prepares_line(rec)}")
            s32, s64 = out[torch.float32], out[torch.float64]
            if not (s32.termination == s64.termination == "CONVERGENCE"
                    and s32.num_iterations <= DOGLEG_MAX_ATTEMPTS
                    and abs(s32.final_rmse_inlier - s64.final_rmse_inlier)
                    <= RMSE_TOL):
                raise AssertionError(
                    f"gs_small scale {scale} {solver}+dogleg: float32 "
                    f"{s32.termination} in {s32.num_iterations} attempts at "
                    f"{s32.final_rmse_inlier}, float64 {s64.termination} at "
                    f"{s64.final_rmse_inlier}")


def gradient_check_phase(ba, card):
    """Phase 6's gradient checks beyond ``covariance_phase``: a float32
    solve of config 1 with ``check_gradients=True`` at the solver's
    default, which must pass and converge, and a Jacobian with J_pt
    scaled by 1.01, which the float32 check must refuse at 2e-3."""
    from rsba_tpu_torch.solver import gradient_check, residuals
    r = solve_config("gs_small", card, "dense+check_gradients", ba=ba,
                     linear_solver="dense", check_gradients=True)
    log(f"gs_small dense+check_gradients [{card}]: the float32 check at "
        f"its default 2e-3 passed inside solve(), solve wall "
        f"{r['wall']:.3f} s")
    evaluate = residuals.evaluate

    def wrong(params, problem):
        ev = evaluate(params, problem)
        return ev._replace(J_pt=ev.J_pt * 1.01)

    gradient_check.residuals.evaluate = wrong
    try:
        gradient_check.check_gradients(ba.problem, ba.params0,
                                       relative_precision=2e-3)
    except ValueError as e:
        log(f"check_gradients (float32, 2e-3, J_pt x 1.01) [{card}]: "
            f"refused  OK: {e}")
    else:
        raise AssertionError("the float32 gradient check passed a Jacobian "
                             "with J_pt scaled by 1.01")
    finally:
        gradient_check.residuals.evaluate = evaluate


def covariance_phase(ba, params, card, label="gs_small"):
    """Covariance and gradient check at a solved float32 problem with two
    poses pinned; the reference is the inverse of the whole dense
    Gauss-Newton matrix over the free dims, in float64 on the card.  An
    intrinsics tangent is part of the camera block: its standard
    deviations are printed and its block is held like the whole."""
    import numpy as np
    import torch
    from rsba_tpu_torch.problem import types
    from rsba_tpu_torch.solver import assembly, residuals
    from rsba_tpu_torch.solver.covariance import compute_covariance
    from rsba_tpu_torch.solver.gradient_check import check_gradients

    dev = ba.problem.device
    pose_free = ba.problem.pose_free.clone()
    pose_free[1] = 0.0
    problem = ba.problem.replace(pose_free=pose_free)
    # float64 twin of the problem on the card, for both references
    p64 = types.problem_from_numpy(problem, device=dev, dtype=torch.float64)
    x64 = params.astype(torch.float64)
    # The float32 Jacobian against float64 central differences, at the
    # float32 default of lm.solve (the JAX package differences in float32,
    # which floors near 1e-2 on this problem), and float64 at 1e-5.
    for name, pr, x, tol in (("float32", problem, params, 2e-3),
                             ("float64", p64, x64, 1e-5)):
        rep = check_gradients(pr, x, relative_precision=tol)
        log(f"check_gradients ({name}, {tol:g}) [{card}]: max relative "
            f"error {rep['max_relative_error']:.3e} over "
            f"{rep['n_checked']} observations  OK")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cov = compute_covariance(problem, params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ni = problem.intr_tangent_dim
    cam_free = torch.cat([pose_free.repeat_interleave(6),
                          problem.intr_free.repeat_interleave(ni)])
    free = torch.nonzero(cam_free > 0)[:, 0]
    S = cov.cam_full[free][:, free].double()
    asym = float((S - S.T).abs().max() / S.abs().max())
    _, info = torch.linalg.cholesky_ex(0.5 * (S + S.T))
    if asym > 1e-4 or int(info) != 0:
        raise AssertionError(f"covariance: asymmetry {asym:.3e}, Cholesky "
                             f"info {int(info)} on the free block")

    # float64 reference on the card
    shapes = assembly.tangent_shapes(p64, x64)
    ev = residuals.evaluate(x64, p64)
    H, _ = assembly.dense_normal_equations(ev, p64, shapes)
    del ev
    counts = torch.zeros(shapes.n_points, dtype=torch.float64, device=dev)
    counts.index_add_(0, p64.obs.point.long(), p64.obs.mask)
    keep = torch.cat([cam_free.to(p64.point_free),
                      (p64.point_free * (counts >= 2)).repeat_interleave(3)])
    idx = torch.nonzero(keep > 0)[:, 0]
    Hinv = torch.linalg.inv(H[idx][:, idx])
    n_cam = int(free.numel())
    ref = Hinv[:n_cam, :n_cam]
    err = float((S - ref).abs().max() / ref.abs().max())
    diag = float(((S.diagonal() - ref.diagonal()).abs()
                  / ref.diagonal()).max())
    log(f"covariance {label} (float32 problem, estimated in float64, Dc "
        f"{cov.cam_full.shape[0]}, "
        f"{shapes.n_points} points) [{card}]: {wall * 1e3:.1f} ms, "
        f"sigma2 {cov.sigma2_estimate:.4f}, free block {n_cam}x{n_cam}: "
        f"asymmetry {asym:.2e}, positive definite, against the float64 "
        f"inverse of the dense {idx.numel()}-dim Gauss-Newton matrix: max|Δ| "
        f"/ max|ref| {err:.3e}, worst diagonal entry {diag:.3e} relative")
    if not err <= 1e-3 or not np.isfinite(cov.sigma2_estimate):
        raise AssertionError(f"covariance: {err:.3e} from the float64 dense "
                             f"inverse (limit 1e-3)")
    if ni:
        # the free intrinsics dims are the last of the free camera dims
        k = int((problem.intr_free.repeat_interleave(ni) > 0).sum())
        Si, ref_i = S[-k:, -k:], ref[n_cam - k:, n_cam - k:]
        err_i = float((Si - ref_i).abs().max() / ref_i.abs().max())
        log(f"covariance {label}, intrinsics tangent ({k} free dims) "
            f"[{card}]: standard deviations "
            f"{Si.diagonal().sqrt().tolist()} (float64 reference "
            f"{ref_i.diagonal().sqrt().tolist()}), max|Δ| / max|ref| "
            f"{err_i:.3e}")
        if not err_i <= 1e-3:
            raise AssertionError(f"covariance of the intrinsics: {err_i:.3e} "
                                 f"from the float64 dense inverse (limit "
                                 f"1e-3)")
    del H, Hinv
    torch.cuda.empty_cache()


def compare_at_session_shapes(sess):
    """The kernel against its plain version on the problems the session
    itself poses after its last frame, the windowed BA and the full BA:
    shape-bucketed (poses to x8, points to x256, observations to x2048),
    with constant and dummy poses and points.  In float32, as the session
    runs them: each output within 1e-4 of max|ref| as at config 4's
    shapes, the two gradients (sums that cancel at the session's solution)
    within that plus four times the plain version's own round-off, and
    equal bits from two launches.  Then the same problems cast to float64,
    where nothing is lost to cancellation: 1e-8 of max|ref|.  Returns the
    worst float32 max|Δ|."""
    import types
    import torch
    from rsba_tpu_torch.problem.types import (params_from_numpy,
                                              problem_from_numpy)
    worst = 0.0
    for name, window in (("windowed", sess.window), ("full", None)):
        problem, params0, _ = sess._build_problem(window)
        ba = types.SimpleNamespace(problem=problem, params0=params0,
                                   name=f"session {name} BA")
        log(f"session {name} BA problem: {params0.n_poses} poses "
            f"({int(problem.pose_free.sum())} free), {params0.n_points} "
            f"points ({int(problem.point_free.sum())} free), "
            f"{problem.obs.n_obs} observation rows "
            f"({int(problem.obs.mask.sum())} valid), {params0.dtype}")
        worst = max(worst, compare(f"session_{name}_ba", ba,
                                   rel_to_max=1e-4,
                                   cancelling=("gw", "g_pt")))
        check_equal_bits(ba)
        ba64 = types.SimpleNamespace(
            problem=problem_from_numpy(problem, device="cuda",
                                       dtype=torch.float64),
            params0=params_from_numpy(params0, device="cuda",
                                      dtype=torch.float64))
        compare(f"session_{name}_ba_float64", ba64, rel_to_max=1e-8)
    return worst


def session_phase(card):
    """The 50-frame session through both loops; returns the kernel's
    launches in the first (``device_loop="auto"``), counted from 0, and
    the kernel's worst max|Δ| from its plain version on that session's own
    windowed and full BA problems."""
    from rsba_tpu_torch.kernels import fused
    from rsba_tpu_torch.tools import pipeline_gpu

    launches = err = None
    for loop in ("auto", "off"):
        fused.fused_evaluate_assemble_cuda.launches = 0
        t0 = time.perf_counter()
        sess, r = pipeline_gpu.drive_session(
            50, 1200, loop, log=log if loop == "auto" else None)
        wall = time.perf_counter() - t0
        n = fused.fused_evaluate_assemble_cuda.launches
        st = r["steady_stage_ms"]
        log(f"session device_loop={loop} [{card}]: {r['frames']} frames, "
            f"{r['matches_per_frame']:.0f} matches a frame, ingest "
            f"{r['total_ingest_s']:.2f} s, steady state "
            f"{r['steady_frames_per_s']:.3f} frames/s "
            f"({r['steady_ms_per_frame']:.1f} ms a frame: register "
            f"{st['register']['mean']:.1f}, triangulate "
            f"{st['triangulate']['mean']:.1f}, BA {st['ba']['mean']:.1f} "
            f"each of {st['ba']['n']}), registered through the prior "
            f"{r['registered_by']['pnp_prior']}, through RANSAC "
            f"{r['registered_by']['ransac']}, graph captures "
            f"{r['graph_captures_total']} in {r['graph_capture_s']:.2f} s, "
            f"kernel launches {n}, peak memory "
            f"{r['peak_memory_gib']:.3f} GiB, whole phase {wall:.1f} s")
        log(f"session device_loop={loop} [{card}]: BA engines "
            f"{r['ba_engines']}; not banded: {r['ba_not_banded']}")
        log(f"session device_loop={loop} [{card}]: final BA "
            f"{r['final_ba_termination']} in {r['final_ba_iterations']} "
            f"attempts, {r['final_ba_wall_s']:.3f} s, engine {r['engine']}, "
            f"inlier RMSE {r['final_ba_rmse_inlier_px']:.5f} px, map "
            f"{r['n_points_map']} points, max relative-rotation error "
            f"{r['max_rel_rotation_err_rad']:.5f} rad")
        log(json.dumps({"session": r}))
        want = "banded_schur/cuda" + ("+device_loop" if loop == "auto"
                                      else "")
        problems = []
        if not (r["bootstrapped"] and r["all_registered"]):
            problems.append("not every frame registered")
        if r["final_ba_termination"] != "CONVERGENCE":
            problems.append(f"final BA {r['final_ba_termination']}")
        if not r["final_ba_rmse_inlier_px"] < 2.5 * PIXEL_NOISE:
            problems.append(f"RMSE {r['final_ba_rmse_inlier_px']}")
        if r["engine"] != want:
            problems.append(f"final BA engine {r['engine']}, want {want}")
        if r["steady_ba_engines"] != [want]:
            problems.append(f"steady-state BA engines "
                            f"{r['steady_ba_engines']}, want {want}")
        if not n > 0 or n != r["kernel_launches"]:
            problems.append(f"{n} kernel launches")
        if problems:
            raise AssertionError(f"session device_loop={loop}: "
                                 + "; ".join(problems))
        if loop == "auto":
            launches = n
            err = compare_at_session_shapes(sess)
        del sess
    return launches, err


def ransac_phase(card):
    """RANSAC-PnP without a prior on one camera looking at a cloud:
    2,000 matches, 40% of them uniform outliers, float32."""
    import numpy as np
    import torch
    from rsba_tpu_torch.geometry import CameraModel, camera
    from rsba_tpu_torch.solver.ransac import ransac_pnp

    rng = np.random.RandomState(5)
    model = CameraModel(rolling_shutter=False, use_distortion=True)
    intr = np.array([800.0, 800.0, 320.0, 240.0, -0.1, 0.02, 0, 0, 0])
    eye = np.array([0.0, 0.0, -2.0])
    q = np.array([1.0, 0.0, 0.0, 0.0])           # looks down +z
    pts = rng.randn(2000, 3) * 0.5
    t64 = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    uv = camera.project_global(t64(q), t64(eye), t64(intr), t64(pts),
                               model).numpy()
    uv = uv + rng.randn(*uv.shape) * PIXEL_NOISE
    out = rng.rand(uv.shape[0]) < 0.4
    uv[out] = rng.uniform(0, 640, size=(int(out.sum()), 2))

    walls = []
    for _ in range(2):        # the first call also loads what it uses
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q_a, c_a, _, _, inliers, info = ransac_pnp(
            pts.astype(np.float32), uv.astype(np.float32), intr, model,
            n_hypotheses=256, inlier_threshold=4.0, seed=0,
            dtype=torch.float32)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    true_in = ~out
    wrong = int((inliers != true_in).sum())
    dq = float(torch.abs(torch.sum(q_a.double().cpu() * t64(q))))
    dc = float(torch.linalg.vector_norm(c_a.double().cpu() - t64(eye)))
    log(f"ransac_pnp (2000 matches, {int(out.sum())} outliers, 256 "
        f"hypotheses, float32) [{card}]: first call {walls[0] * 1e3:.1f} "
        f"ms, second {walls[1] * 1e3:.1f} ms (polish "
        f"{info['summary'].total_time * 1e3:.1f} ms), best "
        f"hypothesis {info['best_inliers_prepolish']} inliers, after the "
        f"polish {info['num_inliers']} of {int(true_in.sum())} true ones, "
        f"{wrong} matches classed otherwise, |q·q_gt| {dq:.7f}, |c − c_gt| "
        f"{dc:.2e}, polish {info['summary'].termination} through "
        f"{info['summary'].linear_solver}/{info['summary'].evaluator}")
    if wrong > 0.02 * true_in.sum() or not dq > 1.0 - 1e-5 or not dc < 5e-3:
        raise AssertionError("ransac_pnp: outside the envelope")


def cli_phase(card):
    """The CLI in-process: config 3 to its anchor, and a checkpointed run
    of config 1 stopped after 3 iterations and resumed."""
    from rsba_tpu_torch.cli import run

    def call(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = run.main(argv)
        lines = buf.getvalue().splitlines()
        for line in lines:
            log(f"  cli: {line}")
        rec = next(json.loads(x) for x in reversed(lines)
                   if x.startswith("{"))
        return rc, rec

    rc, rec = call(["--config", "rs_video_linear"])
    if rc != 0 or abs(rec["final_rmse_inlier_px"]
                      - RMSE_ANCHOR["rs_video_linear"]) > RMSE_TOL:
        raise AssertionError(f"cli rs_video_linear: rc {rc}, {rec}")
    if (rec["solver"], rec["evaluator"]) != ("banded_schur",
                                             "cuda+device_loop"):
        raise AssertionError(f"cli rs_video_linear: engine {rec}")
    with tempfile.TemporaryDirectory() as d:
        base = ["--config", "gs_small", "--checkpoint-dir", d + "/ckpt"]
        rc1, rec1 = call(base + ["--max-iterations", "3", "--jsonl",
                                 d + "/first.jsonl"])
        rc2, rec2 = call(base + ["--resume", "--jsonl", d + "/all.jsonl"])
        with open(d + "/first.jsonl") as f:
            n1 = len(f.readlines())
        with open(d + "/all.jsonl") as f:
            its = [json.loads(x)["iteration"] for x in f]
    if rc1 != 2 or rec1["termination"] != "NO_CONVERGENCE":
        raise AssertionError(f"cli checkpointed run: rc {rc1}, {rec1}")
    if (rc2 != 0 or abs(rec2["final_rmse_inlier_px"]
                        - RMSE_ANCHOR["gs_small"]) > RMSE_TOL):
        raise AssertionError(f"cli resumed run: rc {rc2}, {rec2}")
    if not (0 < n1 < len(its)) or its != list(range(len(its))):
        raise AssertionError(f"cli resumed run: history {its} after {n1} "
                             "records")
    log(f"cli [{card}]: rs_video_linear {rec['final_rmse_inlier_px']:.5f} px "
        f"in {rec['wall_s']} s; gs_small stopped after {n1} records and "
        f"resumed to {len(its)} records, {rec2['final_rmse_inlier_px']:.5f} "
        f"px  OK")


def check_rank_records(name, recs, anchor, want_engine):
    """Every rank converged to within RMSE_TOL of the anchor through the
    engine, with one kernel launch per prepare on the banded engine, and
    all ranks took the same accept sequence to the same final cost."""
    for r in recs:
        log(f"{name} rank {r['rank']}/{r['ranks']} ({r['backend']}, "
            f"{r['device']}): {r['engine']}, {r['termination']} in "
            f"{r['iterations']} attempts {r['seq']}, CG {r['cg']}, inlier "
            f"RMSE {r['rmse_inlier']:.5f} px (anchor {anchor}), solve "
            f"{r['wall_s']:.3f} s, prepares {r['prepares']}, kernel launches "
            f"{r['kernel_launches']}, all-reduces {r['all_reduces']} "
            f"({r['all_reduce_bytes_per_attempt']:.0f} B an attempt), "
            f"max_memory_allocated {r['max_memory_gib']:.3f} GiB")
        problems = []
        if r["engine"] != want_engine:
            problems.append(f"engine {r['engine']}, want {want_engine}")
        if r["termination"] != "CONVERGENCE" or not r["finite"]:
            problems.append(f"{r['termination']} ({r['message']})")
        if abs(r["rmse_inlier"] - anchor) > RMSE_TOL:
            problems.append(f"inlier RMSE {r['rmse_inlier']}")
        banded = want_engine.startswith("banded_schur/cuda")
        if banded and not (r["kernel_launches"] > 0
                           and r["kernel_launches"] == r["prepares"]):
            problems.append(f"{r['kernel_launches']} kernel launches for "
                            f"{r['prepares']} prepares")
        if problems:
            raise AssertionError(f"{name} rank {r['rank']}: "
                                 + "; ".join(problems))
    if len({(r["seq"], r["final_cost"]) for r in recs}) != 1:
        raise AssertionError(f"{name}: the ranks' records differ: "
                             f"{[(r['seq'], r['final_cost']) for r in recs]}")


def dist_phase(card, host_seq):
    """Phase 10: the distributed solvers on the one card (functional
    only: ranks that share a card measure no scaling).  ``host_seq`` is
    phase 3's host-loop accept sequence of config 4.  Returns the kernel
    launches of the sharded config-4 solves: the one-rank world's and
    each rank's of the two-rank world."""
    import torch
    from rsba_tpu_torch import entry
    from rsba_tpu_torch.cli import run
    from rsba_tpu_torch.dist import launch
    from rsba_tpu_torch.kernels import fused
    from rsba_tpu_torch.problem import synthetic
    from rsba_tpu_torch.tools import dist_gpu

    log(f"phase 10, distributed, functional only: one card [{card}]")
    # entry(): one LM iteration on the tiny flagship through the kernel
    fn, (params0, radius) = entry.entry()
    fused.fused_evaluate_assemble_cuda.launches = 0
    params, (cost, decrease, predicted, cg) = fn(params0, radius)
    torch.cuda.synchronize()
    n = fused.fused_evaluate_assemble_cuda.launches
    if not (n == 1 and float(decrease) > 0 and float(predicted) > 0
            and torch.isfinite(params.points).all()):
        raise AssertionError(f"entry(): {n} launches, decrease "
                             f"{float(decrease)}, predicted "
                             f"{float(predicted)}")
    log(f"entry() [{card}]: cost {float(cost):.6e}, decrease "
        f"{float(decrease):.6e}, predicted {float(predicted):.6e}, CG "
        f"{int(cg)}, kernel launches {n}  OK")

    for n_ranks, backend in ((1, None), (2, "gloo")):
        t0 = time.perf_counter()
        recs = entry.dryrun_multichip(n_ranks, backend=backend)
        log(f"dryrun_multichip({n_ranks}, backend={backend}) [{card}]: "
            f"{[(r['rank'], r['device'], r['backend']) for r in recs]}, "
            f"engines {recs[0]['engine_banded']} and "
            f"{recs[0]['engine_flat']}, cost {recs[0]['cost']:.6e} -> "
            f"{recs[0]['banded_new_cost']:.6e} (banded), "
            f"{recs[0]['flat_new_cost']:.6e} (flat), "
            f"{time.perf_counter() - t0:.1f} s  OK")
        if recs[0]["engine_banded"] != ("banded_schur", "cuda-sharded"):
            raise AssertionError(f"dryrun engine {recs[0]['engine_banded']}")
        if len({(r["banded_new_cost"], r["flat_new_cost"])
                for r in recs}) != 1:
            raise AssertionError(f"dryrun: ranks differ: {recs}")

    # Config 4 through the banded sharded engine: one rank on NCCL, here
    job = {"config": "rs_slerp_robust", "dtype": "f32", "solver": "auto",
           "max_iterations": 60}
    with launch.single_rank() as mesh:
        one = dist_gpu.solve_rank(mesh, job)
    check_rank_records("rs_slerp_robust, 1 rank on nccl", [one],
                       RMSE_ANCHOR["rs_slerp_robust"],
                       "banded_schur/cuda-sharded")
    if one["seq"] != host_seq:
        raise AssertionError(f"config 4 on one NCCL rank took {one['seq']}, "
                             f"the host loop {host_seq}")
    log(f"rs_slerp_robust, 1 rank on nccl: the host loop's accept sequence "
        f"{host_seq}  OK")
    torch.cuda.empty_cache()

    # ... and on two gloo ranks sharing the card, each rank's kernel
    # outputs held to the one-process launch's rows
    recs = launch.spawn(dist_gpu.solve_rank, 2, "gloo", "cuda",
                        dict(job, kernel_rows=True))
    check_rank_records("rs_slerp_robust, 2 ranks on gloo", recs,
                       RMSE_ANCHOR["rs_slerp_robust"],
                       "banded_schur/cuda-sharded")
    ba4 = synthetic.CONFIGS["rs_slerp_robust"](scale=1.0,
                                               dtype=torch.float32,
                                               device="cuda")
    _, _, _, inp = kernel_inputs(ba4)
    whole = fused.fused_evaluate_assemble_cuda(
        *inp, model=ba4.problem.model, loss=ba4.problem.loss)
    for r in recs:
        r0, r1 = r["rows"]
        for k, v in r.pop("kernel_out").items():
            if not torch.equal(v, whole[k][r0:r1].cpu()):
                raise AssertionError(f"rank {r['rank']}: kernel output {k} "
                                     f"of rows [{r0}, {r1}) differs from "
                                     "the one-process launch")
        log(f"rank {r['rank']} rows [{r0}, {r1}): the kernel's six row "
            f"outputs torch.equal to the one-process launch's rows  OK")
    del ba4, inp, whole
    torch.cuda.empty_cache()

    # Config 1 on two gloo ranks through the flat sharded engines
    for solver in ("iterative_schur", "dense_schur"):
        flat = launch.spawn(dist_gpu.solve_rank, 2, "gloo", "cuda",
                            dict(job, config="gs_small", solver=solver))
        check_rank_records(f"gs_small {solver}, 2 ranks on gloo", flat,
                           RMSE_ANCHOR["gs_small"],
                           f"{solver}/torch-flat-sharded")

    # The CLI's --shard on config 3 (one card: one rank on NCCL)
    buf = io.StringIO()
    fused.fused_evaluate_assemble_cuda.launches = 0
    with contextlib.redirect_stdout(buf):
        rc = run.main(["--config", "rs_video_linear", "--shard"])
    launches_cli = fused.fused_evaluate_assemble_cuda.launches
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"  cli --shard: {line}")
    rec = next(json.loads(x) for x in reversed(lines) if x.startswith("{"))
    if (rc != 0 or (rec["solver"], rec["evaluator"])
            != ("banded_schur", "cuda-sharded") or launches_cli < 1
            or abs(rec["final_rmse_inlier_px"]
                   - RMSE_ANCHOR["rs_video_linear"]) > RMSE_TOL):
        raise AssertionError(f"cli --shard rs_video_linear: rc {rc}, "
                             f"{launches_cli} launches, {rec}")
    log(f"cli --shard [{card}]: rs_video_linear "
        f"{rec['final_rmse_inlier_px']:.5f} px through "
        f"{rec['solver']}/{rec['evaluator']}, {launches_cli} kernel "
        f"launches  OK")
    return one["kernel_launches"], [r["kernel_launches"] for r in recs]


def self_calibration_problem(dtype):
    """Config 1 with its one intrinsics block freed for self-calibration
    (focal tied over fx and fy, cx, cy) and started off: fx, fy x 1.01,
    cx + 2 px, cy - 2 px."""
    import dataclasses
    import torch
    from rsba_tpu_torch.geometry.camera import CX, CY, FX, FY
    from rsba_tpu_torch.problem import synthetic
    from rsba_tpu_torch.problem.types import intr_basis_subset
    ba = synthetic.CONFIGS["gs_small"](scale=1.0, dtype=dtype, device="cuda")
    basis = intr_basis_subset([FX, CX, CY], tie_focal=True)
    intr = ba.params0.intr.clone()
    intr[:, [FX, FY]] *= 1.01
    intr[:, CX] += 2.0
    intr[:, CY] -= 2.0
    return dataclasses.replace(
        ba, name="gs_small_selfcal",
        problem=ba.problem.replace(intr_basis=torch.as_tensor(
            basis, dtype=dtype, device=ba.problem.device)),
        params0=ba.params0.replace(intr=intr))


def self_calibration_phase(card):
    """Phase 11: self-calibration of config 1's shared camera, float32
    through the default options and ``dense_schur`` beside float64
    ``dense_schur``, then the covariance at the float32 ``dense_schur``
    solution."""
    import torch
    from rsba_tpu_torch.geometry.camera import CX, CY, FX
    t0 = time.perf_counter()
    log(f"phase 11, self-calibration [{card}]: the flat engines, whose "
        "prepare is residuals.evaluate: no kernel of csrc/ is launched")
    name = "gs_small_selfcal"
    f64 = solve_config(name, card, "float64 dense_schur",
                       ba=self_calibration_problem(torch.float64),
                       linear_solver="dense_schur")
    want = f64["params"].intr[0, [FX, CX, CY]].tolist()
    if abs(want[0] - SELFCAL_FOCAL_F64) > 0.01:
        raise AssertionError(f"{name} float64: focal {want[0]}, measured "
                             f"{SELFCAL_FOCAL_F64} on the CPU")
    ba = self_calibration_problem(torch.float32)
    log(f"{name} [{card}]: n_obs {int(ba.problem.obs.mask.sum())}, poses "
        f"{ba.params0.n_poses}, points {ba.params0.n_points}, intrinsics "
        f"tangent {ba.problem.intr_tangent_dim} (f, cx, cy) from "
        f"{ba.params0.intr[0, [FX, CX, CY]].tolist()}; float64 solution "
        f"{want}")
    runs = {}
    for tag, kw in (("default", {}), ("dense_schur",
                                      {"linear_solver": "dense_schur"})):
        r = solve_config(name, card, tag, ba=ba, **kw)
        got = r["params"].intr[0, [FX, CX, CY]].tolist()
        engine = r["summary"].linear_solver
        log(f"{name} {tag} [{card}]: {engine}, recovered (f, cx, cy) "
            f"{got} against float64 {want}, kernel launches "
            f"{r['launches']}")
        if engine != kw.get("linear_solver", "iterative_schur"):
            raise AssertionError(f"{name} {tag}: engine {engine}")
        if abs(got[0] - SELFCAL_FOCAL_F64) > 2.0:
            raise AssertionError(f"{name} {tag}: focal {got[0]} not within "
                                 f"2 px of {SELFCAL_FOCAL_F64}")
        if r["launches"] != 0:
            raise AssertionError(f"{name} {tag}: {r['launches']} kernel "
                                 "launches on the flat path")
        runs[tag] = r
    covariance_phase(ba, runs["dense_schur"]["params"], card, label=name)
    log(f"phase 11 [{card}]: {time.perf_counter() - t0:.1f} s")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's smoke run needs one "
                           "GPU")
    from rsba_tpu_torch.kernels import build, fused
    from rsba_tpu_torch.problem import synthetic
    from rsba_tpu_torch.utils import roofline
    from rsba_tpu_torch.utils.roofline import kernel_bound
    FP32_FLOP_PER_S, HBM_BYTES_PER_S = roofline.peaks()

    # --- 1. environment and build ------------------------------------------
    card = gpu_name_and_power()
    log(card)
    nvcc = build.find_nvcc()
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True,
                              text=True, timeout=60).stdout.strip()
    try:
        import triton
        triton_ver = triton.__version__
    except ImportError:
        triton_ver = "not installed"
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, triton {triton_ver}, device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(f"nvcc {nvcc}: {nvcc_ver.splitlines()[-1]}")
    t0 = time.perf_counter()
    lib = build.load("fused_evaluate_assemble")
    log(f"kernel build {time.perf_counter() - t0:.2f} s "
        f"(nvcc {lib.build_seconds:.2f} s) -> {lib.path.name}")
    for line in lib.build_log.splitlines():
        if "Compiling entry" in line or "registers" in line \
                or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # --- 2. kernel vs plain version ---------------------------------------
    for name, kw in fixtures().items():
        ba = synthetic.make_ba_problem(dtype=torch.float64, device="cuda",
                                       **kw)
        compare(name, ba, rtol=1e-9, atol=1e-9)
        if name == "flagship_slerp_dist_huber":
            compare(name + "+same_pose", ba, rtol=1e-9, atol=1e-9,
                    edit=same_pose_on_some_slots)
        if name == "rs_nlerp":
            compare(name + "+session_shaped", session_shaped(ba), rtol=1e-9,
                    atol=1e-9)
    ba = synthetic.make_ba_problem(dtype=torch.float64, device="cuda",
                                   **chunked_fixture())
    plan = kernel_inputs(ba)[0]
    if fused.launch_plan(plan.W, plan.G, 8, True).chunks < 2:
        raise AssertionError("the chunked fixture fits one tile")
    compare("chunked_slerp_dist_huber", ba, rtol=1e-9, atol=1e-9)
    del ba
    ba4 = synthetic.CONFIGS["rs_slerp_robust"](scale=1.0,
                                               dtype=torch.float32,
                                               device="cuda")
    err4 = compare("config4_shapes", ba4, rel_to_max=1e-4)
    check_equal_bits(ba4)
    bound = kernel_bound(kernel_inputs(ba4)[3], ba4.problem.model,
                         ba4.problem.loss)
    log(f"kernel bound at config-4 shapes (float32): inputs "
        f"{bound['bytes_in']} B + outputs {bound['bytes_out']} B at "
        f"{HBM_BYTES_PER_S:.3g} B/s = {bound['bytes_ms']:.4f} ms; "
        f"{bound['valid_slots']} valid slots x "
        f"{bound['flops'] // bound['valid_slots']} FLOP = "
        f"{bound['flops']} FLOP at {FP32_FLOP_PER_S:.3g} FLOP/s = "
        f"{bound['ops_ms']:.4f} ms; bound {bound['bound_ms']:.4f} ms by "
        f"{bound['bound_by']}")
    times = time_prepares(ba4)
    log(f"kernel {times['kernel']:.3f} ms is "
        f"{times['kernel'] / bound['bound_ms']:.1f}x its bound")
    del ba4
    torch.cuda.empty_cache()

    # --- 3. config 4, the main path: the captured loop ----------------------
    first = solve_config("rs_slerp_robust", card, "captured loop #1")
    if abs(first["n_obs"] - N_OBS_CONFIG4) > 0.001 * N_OBS_CONFIG4:
        raise AssertionError(f"config 4 has {first['n_obs']} observations, "
                             f"want about {N_OBS_CONFIG4}")
    if first["summary"].linear_solver != "banded_schur":
        raise AssertionError("config 4 did not resolve to banded_schur")
    again = solve_config("rs_slerp_robust", card, "captured loop #2",
                         ba=first["ba"], fns=first["fns"])
    if again["seq"] != first["seq"]:
        raise AssertionError(
            f"two looped config-4 solves differ: {first['seq']} then "
            f"{again['seq']}")
    log(f"two looped config-4 solves: the same {len(first['seq'])} valid "
        f"attempts {first['seq']}  OK")
    host = solve_config("rs_slerp_robust", card, "host loop",
                        ba=first["ba"], device_loop="off")
    log(f"rs_slerp_robust [{card}]: captured loop {again['wall']:.3f} s "
        f"({first['wall']:.3f} s with warm-up and capture) against host "
        f"loop {host['wall']:.3f} s; sequences {again['seq']} / "
        f"{host['seq']}; CG iterations {again['cg']} / {host['cg']}")
    launches, launches_host = again["launches"], host["launches"]
    host_seq = host["seq"]
    del first, again, host
    torch.cuda.empty_cache()

    # --- 4. config 3 --------------------------------------------------------
    c3 = solve_config("rs_video_linear", card, "captured loop")
    c3c = solve_config("rs_video_linear", card, "cluster_jacobi",
                       ba=c3["ba"], preconditioner="cluster_jacobi")
    log(f"rs_video_linear [{card}]: summed CG iterations schur_jacobi "
        f"{c3['cg']}, cluster_jacobi {c3c['cg']}; walls {c3['wall']:.3f} s, "
        f"{c3c['wall']:.3f} s")
    del c3, c3c
    torch.cuda.empty_cache()

    # --- 5. configs 1 and 2: the flat engines -------------------------------
    c1 = solve_config("gs_small", card, "dense", linear_solver="dense")
    dogleg_config("gs_small", card, "dense+dogleg", c1["ba"], "dense")
    dogleg_config("gs_small", card, "dense_schur+dogleg", c1["ba"],
                  "dense_schur")
    dogleg_scales(card)

    # --- 6. covariance and gradient check at config 1's solution ------------
    covariance_phase(c1["ba"], c1["params"], card)
    gradient_check_phase(c1["ba"], card)
    del c1
    torch.cuda.empty_cache()
    c2 = solve_config("gs_bal", card, "dense_schur",
                      linear_solver="dense_schur")
    dogleg_config("gs_bal", card, "dense_schur+dogleg", c2["ba"],
                  "dense_schur")
    del c2
    torch.cuda.empty_cache()

    # --- 7. the video-SfM session -------------------------------------------
    launches_session, err_session = session_phase(card)
    torch.cuda.empty_cache()

    # --- 8. RANSAC without a prior; 9. the CLI ------------------------------
    ransac_phase(card)
    cli_phase(card)
    torch.cuda.empty_cache()

    # --- 10. the distributed solvers, functional only on one card ---------
    launches_sharded, launches_sharded_ranks = dist_phase(card, host_seq)
    torch.cuda.empty_cache()

    # --- 11. self-calibration of a shared camera, flat engines -------------
    self_calibration_phase(card)

    log(json.dumps({"kernels": [{
        "name": "fused_evaluate_assemble", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": launches, "launches_per_solve": launches,
        "launches_host_loop": launches_host,
        "launches_session": launches_session,
        "launches_sharded_1rank_nccl": launches_sharded,
        "launches_sharded_2rank_gloo": launches_sharded_ranks,
        "max_abs_err": err4, "max_abs_err_session": err_session,
        "ms": times["kernel"], "plain_ms": times["plain"],
        "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
        "library_ms": None,
        "prepare_ms": times["prepare_kernel"],
        "plain_prepare_ms": times["prepare_plain"]}]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
