"""Roofline accounting for the solver's hot phases.

Counterpart of ``rsba_tpu/utils/roofline.py``.  Each phase function of an
``lm.make_solver_fns`` dict (prepare = evaluate + assemble, solve_step =
the damped Schur solve) is timed, with CUDA events on a CUDA device and
``perf_counter`` on the CPU, and its time is set against this module's own
counts of the operations and bytes the phase needs:

* achieved FLOP/s and bytes/s,
* mfu            = achieved FLOP/s / peak FLOP/s,
* bandwidth_util = achieved bytes/s / peak bytes/s,
* arithmetic intensity and the bound (compute or memory) with its
  utilisation.

There is no compiler cost model to ask, so the counts are computed from
shapes, for the parts that carry a phase of the banded engine: the fused
evaluate+assemble kernel (``kernel_bound``, ``slot_flops``) for prepare;
the F C⁻¹ Fᵀ batched product and the PCG's band products for solve_step
(``solve_step_counts``); the band PCG kernel's bytes (``band_pcg_bound``)
and the residual pass's (``residual_pass_bound``).  The element-wise
work around them is not counted, so a phase's utilisation is a lower
bound; a phase of an engine with no count here reports its time and
``"flops": None, "bytes": None``.

Peaks are the published ones of one NVIDIA H100 SXM: 3.35 TB/s of device
memory and 67 TFLOP/s in float32 outside the tensor cores (every counted
operation runs there: TF32 is off for the normal equations).  Override
with RSBA_PEAK_FLOPS / RSBA_PEAK_BYTES_S for another card.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Optional

import torch

H100_PEAK_FLOPS = 67e12       # float32, outside the tensor cores
H100_PEAK_BYTES_S = 3.35e12   # device memory


def peaks():
    """(peak FLOP/s, peak bytes/s), the environment's override first."""
    return (float(os.environ.get("RSBA_PEAK_FLOPS", H100_PEAK_FLOPS)),
            float(os.environ.get("RSBA_PEAK_BYTES_S", H100_PEAK_BYTES_S)))


# --- counts ------------------------------------------------------------------

def slot_flops(model, loss) -> int:
    """Floating-point operations the fused kernel's algorithm needs for
    one valid slot (an FMA counts 2), read off the arithmetic of the CUDA
    source: the rotation chain on duals with 6 tangents (3 without
    rolling shutter), the projection side as plain 2x3 products."""
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
    """The least time the card could take for one call of the fused kernel
    on these inputs: every input read once and every output written once
    at the memory rate, against the valid slots' operations at the
    float32 rate."""
    peak_flops, peak_bw = peaks()
    win, pts = inp[0], inp[1]
    NR, W, _ = win.shape
    G = pts.shape[2]
    size = win.element_size()
    n_valid = int((inp[5] > 0).sum())
    bytes_in = sum(x.numel() * x.element_size() for x in inp)
    bytes_out = size * (NR + NR * W * (6 + 36 + 36) + NR * G * (3 + 6)
                        + NR * W * 18 * G)
    flops = n_valid * slot_flops(model, loss)
    t_bytes = (bytes_in + bytes_out) / peak_bw * 1e3
    t_ops = flops / peak_flops * 1e3
    return {"bytes_in": bytes_in, "bytes_out": bytes_out, "flops": flops,
            "valid_slots": n_valid, "bytes_ms": t_bytes, "ops_ms": t_ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def solve_step_counts(NR: int, W: int, G: int, P: int, itemsize: int,
                      cg_passes: int) -> dict:
    """Operations and bytes of the two products that carry the banded
    ``solve_step``: F C⁻¹ Fᵀ as one batched (6W × 3G)·(3G × 6W) product
    per window row (its two operands read, the (6W)² result written), and
    ``cg_passes`` band products of P block rows of 6 × 6(2W−1) (the rows
    and the gathered neighbours read, 6 values a pose written)."""
    k = 6 * W
    bmm_flops = 2 * NR * k * k * 3 * G
    bmm_bytes = itemsize * NR * (2 * k * 3 * G + k * k)
    row = 6 * (2 * W - 1)
    band_flops = 2 * P * 6 * row
    band_bytes = itemsize * P * (6 * row + row + 6)
    return {"flops": bmm_flops + cg_passes * band_flops,
            "bytes": bmm_bytes + cg_passes * band_bytes,
            "bmm_flops": bmm_flops, "bmm_bytes": bmm_bytes,
            "band_product_flops": band_flops,
            "band_product_bytes": band_bytes, "cg_passes": cg_passes}


def band_pcg_bound(P: int, W: int, itemsize: int, live_passes: int) -> dict:
    """The time of ``live_passes`` passes of the band PCG kernel
    (``kernels/band_pcg.py``) at the HBM rate: a pass reads the P block
    rows of 6 × 6(2W−1) and the 6 × 6 inverses once, and four vectors of
    6P (p, q, r, z) once each.  Not a least time for either launch plan:
    rows kept in shared memory cross HBM once a launch, and a streamed
    pass of config 5's size fits the L2."""
    _, peak_bw = peaks()
    per_pass = itemsize * P * (6 * 6 * (2 * W - 1) + 36 + 4 * 6)
    return {"bytes_per_pass": per_pass, "live_passes": live_passes,
            "bound_ms": live_passes * per_pass / peak_bw * 1e3}


def residual_pass_bound(NR: int, L: int, G: int, itemsize: int,
                        W: int = 0) -> dict:
    """The time of one residual pass (``kernels/fused.py::residual_pass``)
    over an (NR, L, G) grid at the HBM rate: a slot reads uv (2 values),
    t, mask, rsf and ρ_ref and the int32 offset and writes ρ (32 B in
    float32); the point planes (NR, 3, G) are read once and, with ``W``,
    the pose windows (NR, W, 8).  The arithmetic (a few hundred FLOP a
    valid slot) is well under it."""
    _, peak_bw = peaks()
    slots = NR * L * G
    slot_bytes = slots * (7 * itemsize + 4)
    other = itemsize * NR * (3 * G + 8 * W + 1)
    total = slot_bytes + other
    return {"slots": slots, "slot_bytes": slot_bytes, "bytes": total,
            "bound_ms": total / peak_bw * 1e3}


def _banded_counts(fns: dict, p, options=None):
    """(prepare counts, solve_step counts) for the banded engine, else
    (None, None)."""
    if fns.get("engine", ("",))[0] != "banded_schur" or "raw" not in fns:
        return None, None
    from ..solver import banded_fused
    plan, problem = fns["raw"]["bound"]
    statics = banded_fused.kernel_statics(plan, problem)
    inp = banded_fused.kernel_inputs(p, plan, problem, statics)
    kb = kernel_bound(inp, problem.model, problem.loss)
    prep = {"flops": float(kb["flops"]),
            "bytes": float(kb["bytes_in"] + kb["bytes_out"])}
    passes = options.max_cg_iterations if options is not None else 100
    step = solve_step_counts(plan.NR, plan.W, plan.G, plan.n_poses,
                             inp[0].element_size(), passes)
    return prep, {"flops": float(step["flops"]),
                  "bytes": float(step["bytes"])}


# --- timing ------------------------------------------------------------------

def _device_of(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
        for v in (a.values() if isinstance(a, dict) else
                  vars(a).values() if hasattr(a, "__dict__") else ()):
            if isinstance(v, torch.Tensor):
                return v.device
    return torch.device("cpu")


def _time_call(call: Callable, args, repeats: int = 5,
               pipeline: int = 10) -> float:
    """Seconds per call: ``pipeline`` calls back to back, best of
    ``repeats`` rounds, after one warm-up call."""
    dev = _device_of(args)
    call(*args)
    best = float("inf")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        for _ in range(repeats):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(pipeline):
                call(*args)
            b.record()
            torch.cuda.synchronize(dev)
            best = min(best, a.elapsed_time(b) * 1e-3 / pipeline)
        return best
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(pipeline):
            call(*args)
        best = min(best, (time.perf_counter() - t0) / pipeline)
    return best


def phase_report(call: Callable, args, repeats: int = 5,
                 counts: Optional[dict] = None) -> dict:
    """Measure one phase: time per call and, where ``counts`` gives its
    ``flops`` and ``bytes``, its place on the roofline."""
    peak_flops, peak_bw = peaks()
    t = _time_call(call, args, repeats)
    rec = {"time_s": t, "flops": None, "bytes": None}
    if counts and counts["flops"] > 0:
        f, b = counts["flops"], counts["bytes"]
        ai = f / max(b, 1.0)
        ridge = peak_flops / peak_bw
        rec.update({
            "flops": f,
            "bytes": b,
            "achieved_flops_s": f / t,
            "achieved_bytes_s": b / t,
            "mfu": f / t / peak_flops,
            "bandwidth_util": b / t / peak_bw,
            "arithmetic_intensity": ai,
            "bound": "compute" if ai >= ridge else "memory",
            # utilisation against the binding roofline
            "roofline_util": (f / t / peak_flops if ai >= ridge
                              else b / t / peak_bw),
        })
    return rec


def solver_report(fns: dict, params, radius, repeats: int = 5,
                  options=None) -> dict:
    """prepare and solve_step rooflines for an ``lm.make_solver_fns`` dict.

    ``params`` in the external layout; converted when the engine keeps its
    own.  Returns {"prepare": {...}, "solve_step": {...}, "iteration":
    {...}}, where "iteration" sums the phases.  ``options`` gives the
    PCG's pass count (default 100).
    """
    to_internal = fns.get("to_internal")
    p = to_internal(params) if to_internal is not None else params
    c_prep, c_step = _banded_counts(fns, p, options)
    prep = phase_report(fns["prepare"], (p,), repeats, c_prep)
    aux = fns["prepare"](p)
    r = torch.as_tensor(radius, dtype=aux["cost"].dtype,
                        device=aux["cost"].device)
    step = phase_report(fns["solve_step"], (aux, r), repeats, c_step)
    it = {"time_s": prep["time_s"] + step["time_s"], "flops": None,
          "bytes": None}
    if prep["flops"] is not None and step["flops"] is not None:
        peak_flops, peak_bw = peaks()
        f = prep["flops"] + step["flops"]
        b = prep["bytes"] + step["bytes"]
        it.update({"flops": f, "bytes": b,
                   "mfu": f / it["time_s"] / peak_flops,
                   "bandwidth_util": b / it["time_s"] / peak_bw})
    return {"prepare": prep, "solve_step": step, "iteration": it}
