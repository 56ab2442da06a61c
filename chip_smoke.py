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
   its slots, and one whose rows are too wide for one shared-memory tile
   so that the kernel walks them in column chunks (rtol = atol = 1e-9);
   then config 4's shapes in float32 (each output within 1e-4·max|ref|,
   summation order over ~L·G terms), two launches on the same inputs
   giving equal bits, the kernel's bound from the shapes, and the
   kernel's and the plain version's times;
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
# Published peaks of one H100 SXM: device memory rate and float32 rate
# outside the tensor cores (the kernel uses none).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


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


def same_pose_on_some_slots(inp):
    """The kernel inputs with pose_b == pose_a (rsf = 0) on every third
    point column: the route where both sides of a slot move one pose."""
    inp = list(inp)
    rsf = inp[7].clone()
    rsf[:, :, ::3] = 0.0
    inp[7] = rsf
    return tuple(inp)


def slot_flops(model, loss) -> int:
    """Floating-point operations the algorithm needs for one valid slot
    (an FMA counts 2), read off the arithmetic of the CUDA source: the
    rotation chain on duals with 6 tangents (3 without rolling shutter),
    the projection side as plain 2x3 products."""
    if not model.rolling_shutter:
        pose, rotate, sums = 0, 165, 112      # 28 window-sum values
    else:
        # dual product 19, dual sum 7, dual x scalar 7, sqrt/sin/cos 10,
        # quotient 20
        pose = {"slerp": 21 + 186 + 388,      # t w, from_aa, q_mul
                "nlerp": 290,                 # blend, normalise
                "lerp_aa": 63 + 186}[model.rotation_interp]
        rotate, sums = 300, 364               # 91 window-sum values
    project = 80 if model.use_distortion else 40
    jac = 135 if model.rolling_shutter else 105     # M dXc, R, M R, scales
    triggs = 185 if loss.kind != "trivial" else 0
    point_side = 27 + 4 * (36 if model.rolling_shutter else 18)
    return pose + rotate + project + jac + triggs + point_side + sums


def kernel_bound(inp, model, loss) -> dict:
    """The least time the card could take for one call on these inputs:
    every input read once and every output written once at the memory
    rate, against the valid slots' operations at the float32 rate."""
    win, pts = inp[0], inp[1]
    NR, W, _ = win.shape
    G = pts.shape[2]
    size = win.element_size()
    n_valid = int((inp[5] > 0).sum())
    bytes_in = sum(x.numel() * x.element_size() for x in inp)
    bytes_out = size * (NR + NR * W * (6 + 36 + 36) + NR * G * (3 + 6)
                        + NR * W * 18 * G)
    flops = n_valid * slot_flops(model, loss)
    t_bytes = (bytes_in + bytes_out) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return {"bytes_in": bytes_in, "bytes_out": bytes_out, "flops": flops,
            "valid_slots": n_valid, "bytes_ms": t_bytes, "ops_ms": t_ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def kernel_inputs(ba):
    """(plan, statics, planes params, kernel inputs) of a problem."""
    from rsba_tpu_torch.solver import banded_fused, window
    plan = window.build_window_plan(ba.problem)
    statics = banded_fused.kernel_statics(plan, ba.problem)
    params = banded_fused.to_internal(ba.params0, plan)
    return plan, statics, params, banded_fused.kernel_inputs(
        params, plan, ba.problem, statics)


def compare(name, ba, rtol=None, atol=None, rel_to_max=None, edit=None):
    """Kernel vs plain version on one problem (``edit`` maps the kernel
    inputs to the ones both versions get); returns max |Δ|."""
    import torch
    from rsba_tpu_torch.kernels import fused
    plan, _, _, inp = kernel_inputs(ba)
    if edit is not None:
        inp = edit(inp)
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
        "launches": launches, "launches_per_solve": launches,
        "max_abs_err": err4,
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
