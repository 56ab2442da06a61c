"""The float32 incremental-SfM session end to end on one CUDA GPU.

    python3 -m rsba_tpu_torch.tools.pipeline_gpu [--frames 50]
        [--points 1200] [--device-loop auto|off|both] [--device cpu]

Counterpart of ``benchmarks/pipeline_tpu.py``: a synthetic rolling-shutter
sequence (nlerp, no distortion, 0.5 px noise, tracks of 8 frames, seed 11)
goes frame by frame through ``SfmSession`` (window 8, a windowed BA every
4 frames, float32, shape buckets, ``linear_solver="auto"``,
``max_iterations=25``): bootstrap, registration, triangulation and
windowed BA, then one full BA.  ``--device-loop`` sets the loop of the
bundle adjustments and of the registrations alike (``auto`` leaves the
registrations to the session's own defaults).  ``run_session`` returns
the reference script's output keys and, beside them, the wall time by
stage, the registrations by method, the engine of every BA, the seconds
of the CUDA-graph captures, the kernel launches counted, and the peak
device memory; the command prints them as one JSON object per run.
``chip_smoke.py`` calls the same function at the default size.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from ..geometry import quaternion as quat
from ..kernels import fused
from ..pipeline import SfmSession
from ..problem import synthetic
from ..solver import lm_device, pnp
from ..solver.options import SolverOptions


def make_sequence(n_frames: int, n_points: int, seed: int = 11,
                  device=None):
    """(problem with ground truth, per-frame (track ids, pixels))."""
    ba = synthetic.make_ba_problem(
        n_poses=n_frames + 1, n_points=n_points, track_len=8,
        rolling_shutter=True, rotation_interp="nlerp",
        use_distortion=False, pixel_noise=0.5, seed=seed, device=device,
        name="pipeline_gpu")
    obs = ba.problem.obs
    m = obs.mask.cpu().numpy() > 0
    pa = obs.pose_a.cpu().numpy()[m]
    pid = obs.point.cpu().numpy()[m]
    uv = obs.uv.cpu().numpy()[m].astype(np.float64)
    order = np.argsort(pa, kind="stable")
    bounds = np.searchsorted(pa[order], np.arange(n_frames + 1))
    frames = [(pid[order[a:b]], uv[order[a:b]])
              for a, b in zip(bounds[:-1], bounds[1:])]
    return ba, frames


def run_session(n_frames: int = 50, n_points: int = 1200,
                device_loop: str = "auto", device=None,
                log=None) -> dict:
    """Drive one session over a fresh sequence and return its record; see
    the module docstring.  ``log``, if given, is called with one line per
    frame."""
    return drive_session(n_frames, n_points, device_loop, device, log)[1]


def drive_session(n_frames: int = 50, n_points: int = 1200,
                  device_loop: str = "auto", device=None, log=None):
    """As ``run_session``; returns (the session after its final full BA,
    the record), so that a caller can pose the session's own problems
    (``SfmSession._build_problem``) once more."""
    ba, frames = make_sequence(n_frames, n_points, device=device)
    dev = ba.problem.device
    on_card = dev.type == "cuda"
    intr = ba.params_gt.intr[0].cpu().numpy()
    sess = SfmSession(
        intr, ba.problem.model, ba.image_size, window=8, ba_interval=4,
        dtype=torch.float32, shape_buckets=True, device=dev,
        options=SolverOptions(linear_solver="auto", max_iterations=25,
                              device_loop=device_loop),
        # "auto" is the options' default: the session's own path
        register_options=None if device_loop == "auto" else
        dataclasses.replace(pnp.default_options(), device_loop=device_loop))
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize(dev)
    launches0 = fused.fused_evaluate_assemble_cuda.launches
    capture_s0 = lm_device._Runner.capture_seconds
    frame_walls = []
    t_first = time.perf_counter()
    for f, (pid, uv) in enumerate(frames):
        t0 = time.perf_counter()
        sess.add_frame(pid, uv, rows=uv[:, 1])
        frame_walls.append(time.perf_counter() - t0)
        if log is not None:
            r = sess.log[-1]
            stages = " ".join(f"{k} {v * 1e3:.1f}"
                              for k, v in r.get("wall_s", {}).items())
            log(f"frame {f:3d}  {frame_walls[-1] * 1e3:8.1f} ms  "
                f"{r.get('event')} {r.get('method', '')}  [{stages}]")
    total = time.perf_counter() - t_first
    t0 = time.perf_counter()
    s = sess.bundle_adjust(window=None)
    final_ba_wall = time.perf_counter() - t0
    launches = fused.fused_evaluate_assemble_cuda.launches - launches0

    # Accuracy: relative-rotation angles against ground truth, which a
    # similarity of the reconstruction leaves unchanged.
    q_est, _, _ = sess.reconstruction()
    q_est = torch.as_tensor(q_est)
    q_gt = ba.params_gt.q[:n_frames].double().cpu()
    angle = lambda q: torch.linalg.vector_norm(  # noqa: E731
        quat.to_axis_angle(quat.relative(q[:-1], q[1:])), dim=-1)
    ang_err = torch.abs(angle(q_est) - angle(q_gt))

    half = len(frame_walls) // 2
    steady = frame_walls[half:]
    stage = {"register": [], "triangulate": [], "ba": []}
    for r in sess.log[half:]:
        for k, v in r.get("wall_s", {}).items():
            if k in stage:
                stage[k].append(v)
    bas = sess.ba_log
    steady_bas = [b for b in bas[:-1] if b["frames"] > half]
    return sess, {
        "device": (torch.cuda.get_device_name(dev) if on_card else "cpu"),
        "device_loop": device_loop,
        "frames": n_frames,
        "matches_per_frame": float(np.mean([len(p) for p, _ in frames])),
        "bootstrapped": sess.bootstrapped,
        "all_registered": bool(all(sess.registered)),
        "n_points_map": len(sess.points),
        "total_ingest_s": total,
        "steady_frames_per_s": len(steady) / max(sum(steady), 1e-9),
        "steady_ms_per_frame": sum(steady) / len(steady) * 1e3,
        "steady_stage_ms": {
            k: {"mean": 1e3 * float(np.mean(v)) if v else None,
                "max": 1e3 * float(np.max(v)) if v else None, "n": len(v)}
            for k, v in stage.items()},
        "registered_by": dict(sess.n_registered_by),
        "ba_engines": [b["engine"] for b in bas],
        "steady_ba_engines": sorted({b["engine"] for b in steady_bas}),
        "ba_not_banded": [b for b in bas
                          if not b["engine"].startswith("banded_schur")],
        "graph_capture_s": lm_device._Runner.capture_seconds - capture_s0,
        "kernel_launches": launches,
        "final_ba_wall_s": final_ba_wall,
        "final_ba_rmse_inlier_px": float(s.final_rmse_inlier),
        "final_ba_termination": s.termination,
        "final_ba_iterations": s.num_iterations,
        "max_rel_rotation_err_rad": float(ang_err.max()),
        "dtype": "float32",
        "engine": f"{s.linear_solver}/{s.evaluator}",
        "pixel_noise": ba.pixel_noise,
        "peak_memory_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                            if on_card else None),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="rsba_tpu_torch.tools.pipeline_gpu",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--frames", type=int, default=50)
    p.add_argument("--points", type=int, default=1200)
    p.add_argument("--device-loop", choices=["auto", "off", "both"],
                   default="both",
                   help="the solver's loop: auto (on the card: captured "
                        "in CUDA graphs), off (host loop), or one run of "
                        "each")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--quiet", action="store_true",
                   help="no line per frame")
    args = p.parse_args(argv)
    device = None if args.device == "cuda" else args.device
    loops = (["auto", "off"] if args.device_loop == "both"
             else [args.device_loop])
    log = None if args.quiet else (lambda m: print(m, flush=True))
    for loop in loops:
        out = run_session(args.frames, args.points, loop, device, log)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
