#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rsba_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

Phases, each raising on failure (exit code 1):

1. environment: the card's name and power limit, the torch / CUDA / nvcc
   / Triton versions, and the build of the CUDA kernels from csrc/;
2. the fused evaluate+assemble kernel against its plain PyTorch version
   on the card: six small float64 fixtures covering every
   specialisation (rtol = atol = 1e-9), then config 4's shapes in
   float32 (each output within 1e-4·max|ref|, summation order over
   ~L·G terms), with the kernel's and the plain version's times;
3. config 4 (rs_slerp_robust, 1,001 poses, 100k points) at full size in
   float32 through ``rsba_tpu_torch.solver.solve``: the engine must be
   banded_schur/cuda, every prepare must launch the kernel, the solve
   must converge to within 0.002 px of the float64 inlier-RMSE anchor;
4. config 3 (rs_video_linear) at full size, the same way.

The last two lines are a JSON record of the kernels and the result line
``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

# float64 CPU anchors of the final inlier RMSE (px),
# benchmarks/baselines/cpu_config4.json and ROADMAP.md.
RMSE_ANCHOR = {"rs_slerp_robust": 0.79695, "rs_video_linear": 0.65990}
RMSE_TOL = 0.002
N_OBS_CONFIG4 = 910092        # benchmarks/SCALING.json, float64 generator
KERNEL_SOURCE = "rsba_tpu_torch/csrc/fused_evaluate_assemble.cu"
KERNEL_REPLACES = "rsba_tpu/kernels/fused.py:469"


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


def kernel_inputs(ba):
    """(plan, statics, planes params, kernel inputs) of a problem."""
    from rsba_tpu_torch.solver import banded_fused, window
    plan = window.build_window_plan(ba.problem)
    statics = banded_fused.kernel_statics(plan, ba.problem)
    params = banded_fused.to_internal(ba.params0, plan)
    return plan, statics, params, banded_fused.kernel_inputs(
        params, plan, ba.problem, statics)


def compare(name, ba, rtol=None, atol=None, rel_to_max=None):
    """Kernel vs plain version on one problem; returns max |Δ|."""
    import torch
    from rsba_tpu_torch.kernels import fused
    plan, _, _, inp = kernel_inputs(ba)
    model, loss = ba.problem.model, ba.problem.loss
    ref = fused.fused_evaluate_assemble_reference(*inp, model=model,
                                                  loss=loss)
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
            ok = err <= rel_to_max * scale
        else:
            ok = bool((d <= atol + rtol * r.abs()).all())
        if not ok:
            raise AssertionError(f"{name}: kernel output {k} differs from "
                                 f"the plain version: max|Δ| {err:.3e}, "
                                 f"max|ref| {scale:.3e}")
    log(f"kernel vs plain {name} ({str(inp[0].dtype)[6:]}, NR={plan.NR} "
        f"W={plan.W} L={plan.L} G={plan.G}): max|Δ| {worst_abs:.3e}, "
        f"max |Δ|/max|ref| {worst_rel:.3e}  OK")
    return worst_abs


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


def solve_config(name, card):
    """Full-size float32 solve through the port's public entry point;
    returns (kernel launches, observations)."""
    import torch
    from rsba_tpu_torch.kernels import fused
    from rsba_tpu_torch.problem import synthetic
    from rsba_tpu_torch.solver import SolverOptions, make_solver_fns, solve

    t0 = time.perf_counter()
    ba = synthetic.CONFIGS[name](scale=1.0, dtype=torch.float32,
                                 device="cuda")
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    n_obs = int(ba.problem.obs.mask.sum())
    opts = SolverOptions(preconditioner="schur_jacobi",
                         max_cg_iterations=100, cg_eta=1e-2,
                         max_iterations=60)
    t0 = time.perf_counter()
    fns = make_solver_fns(ba.problem, opts)
    build_s = time.perf_counter() - t0
    prepares = [0]
    inner = fns["prepare"]

    def counted_prepare(p):
        prepares[0] += 1
        return inner(p)

    fns["prepare"] = counted_prepare
    torch.cuda.reset_peak_memory_stats()
    fused.fused_evaluate_assemble_cuda.launches = 0
    params, s = solve(ba.problem, ba.params0, opts, fns=fns)
    torch.cuda.synchronize()
    launches = fused.fused_evaluate_assemble_cuda.launches
    mem = torch.cuda.max_memory_allocated()
    n_it = s.num_iterations
    log(f"{name} [{card}]: n_obs {n_obs}, poses {ba.problem.pose_free.numel()}"
        f", points {ba.problem.point_free.numel()}, generate {gen_s:.2f} s, "
        f"plan+engine build {build_s:.2f} s")
    log(f"{name} [{card}]: engine {s.linear_solver}/{s.evaluator}, "
        f"{s.termination} ({s.message}), LM iterations {n_it} "
        f"({s.num_successful_steps} accepted), prepares {prepares[0]}, "
        f"kernel launches {launches}")
    log(f"{name} [{card}]: cost {s.initial_cost:.6e} -> {s.final_cost:.6e}, "
        f"inlier RMSE {s.final_rmse_inlier:.5f} px (anchor "
        f"{RMSE_ANCHOR[name]}), solve wall {s.total_time:.3f} s, "
        f"{s.total_time / max(n_it, 1) * 1e3:.2f} ms per LM iteration, "
        f"evaluation {s.evaluation_time:.3f} s, linear solver "
        f"{s.linear_solver_time:.3f} s, max_memory_allocated "
        f"{mem / 2**30:.3f} GiB")

    if (s.linear_solver, s.evaluator) != ("banded_schur", "cuda"):
        raise AssertionError(f"{name}: engine {s.linear_solver}/"
                             f"{s.evaluator}, want banded_schur/cuda")
    if not (launches > 0 and launches == prepares[0]):
        raise AssertionError(f"{name}: {launches} kernel launches for "
                             f"{prepares[0]} prepares")
    if s.termination != "CONVERGENCE":
        raise AssertionError(f"{name}: {s.termination} ({s.message})")
    if abs(s.final_rmse_inlier - RMSE_ANCHOR[name]) > RMSE_TOL:
        raise AssertionError(f"{name}: inlier RMSE {s.final_rmse_inlier} "
                             f"not within {RMSE_TOL} of {RMSE_ANCHOR[name]}")
    for f in ("q", "c", "intr", "points"):
        x = getattr(params, f)
        if not torch.isfinite(x).all():
            raise AssertionError(f"{name}: non-finite {f}")
    if tuple(params.points.shape) != tuple(ba.params0.points.shape):
        raise AssertionError(f"{name}: points shape {params.points.shape}")
    return launches, n_obs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's smoke run needs one "
                           "GPU")
    from rsba_tpu_torch.kernels import build, fused
    from rsba_tpu_torch.problem import synthetic

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
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # --- 2. kernel vs plain version ---------------------------------------
    for name, kw in fixtures().items():
        ba = synthetic.make_ba_problem(dtype=torch.float64, device="cuda",
                                       **kw)
        compare(name, ba, rtol=1e-9, atol=1e-9)
    ba4 = synthetic.CONFIGS["rs_slerp_robust"](scale=1.0,
                                               dtype=torch.float32,
                                               device="cuda")
    err4 = compare("config4_shapes", ba4, rel_to_max=1e-4)
    times = time_prepares(ba4)
    del ba4
    torch.cuda.empty_cache()

    # --- 3. config 4, the main path ----------------------------------------
    launches, n_obs = solve_config("rs_slerp_robust", card)
    if abs(n_obs - N_OBS_CONFIG4) > 0.001 * N_OBS_CONFIG4:
        raise AssertionError(f"config 4 has {n_obs} observations, "
                             f"want about {N_OBS_CONFIG4}")
    torch.cuda.empty_cache()

    # --- 4. config 3 --------------------------------------------------------
    solve_config("rs_video_linear", card)

    log(json.dumps({"kernels": [{
        "name": "fused_evaluate_assemble", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": launches, "max_abs_err": err4,
        "ms": times["kernel"], "plain_ms": times["plain"],
        "prepare_ms": times["prepare_kernel"],
        "plain_prepare_ms": times["prepare_plain"]}]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
