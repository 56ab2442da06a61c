"""Fused evaluate + assemble: CUDA kernel wrapper and its plain version.

Counterpart of ``rsba_tpu/kernels/fused.py::fused_evaluate_assemble``.
One pass over the (NR, G, L) window grid computes residuals, 15-tangent
Jacobians, the Triggs correction and the masked reductions to the
banded normal-equation blocks, in the planes layout
``solver/banded_fused.py`` consumes:

    cost   scalar          ½ Σ ρ over valid slots
    gw     (NR, W, 6)      g_cam window sums (fold → (P, 6))
    b0, b1 (NR, W, 36)     B band d=0 / d=1 window sums
    g_pt   (NR, 3, G)      point gradients
    c6     (NR, 6, G)      per-point 3×3 JᵀJ, packed [00 01 02 11 12 22]
    F      (NR, W, 18, G)  camera-point blocks, comp = 3a + p

Inputs: win (NR, W, 8) pose windows [q, c, pose_free], pts (NR, 3, G),
ptf (NR, G), uv (NR, 2, L, G), tt/mask/rsf (NR, L, G), offs (NR, L, G)
int32, intr (9,).

``fused_evaluate_assemble_cuda`` launches the hand-written kernel
(``csrc/fused_evaluate_assemble.cu``) on CUDA tensors and raises on any
other; ``fused_evaluate_assemble_reference`` is the plain PyTorch version
(``banded.evaluate_slots`` + ``banded.assemble_windows``);
``fused_evaluate_assemble`` picks the kernel for CUDA tensors and the
plain version for CPU tensors.

The kernel runs one block per window row, one thread per point column,
and keeps the row's (W, 18, columns) tile of F in shared memory.
``launch_plan`` chooses the block's threads and the tile's width from the
shape: the whole row where it has at most 128 columns and its tile fits,
else the same kernel walks the row in column chunks.  It is one kernel
for every shape; a shape it cannot take raises.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..geometry import CameraModel, Loss
from ..solver import banded
from ..solver.window import MAX_WINDOW

#: symmetric 3×3 component order in c6 packing
C6_PAIRS = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
#: diagonal component positions within the c6 packing
C6_DIAG = (0, 3, 5)

_INTERP = {"slerp": 0, "nlerp": 1, "lerp_aa": 2}
_LOSS = {"trivial": 0, "huber": 1, "soft_l1": 2, "cauchy": 3}
MAX_G = 1024   # points per row

# Shared memory of an H100 SM: what one block may take, what the SM has,
# and what the runtime keeps back for each resident block (bytes).
SMEM_BLOCK = 232448
SMEM_SM = 233472
SMEM_RESERVED = 1024
# Values per window pose in the kernel's shared memory, as in the CUDA
# source: the prologue (PRO_VALUES) and one warp's window-sum accumulator
# with and without rolling shutter (K_RS, K_GS).
_PRO_VALUES, _K_RS, _K_GS = 74, 96, 32
MAX_THREADS = 128


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How the kernel covers one window row."""
    threads: int      # per block; one block per row
    tile_cols: int    # columns of the F tile in shared memory
    chunks: int       # column chunks the block walks (1: the whole row)
    smem_bytes: int   # dynamic shared memory of the block
    blocks_per_sm: int  # resident blocks that shared memory allows


def _round4(n: int) -> int:
    return (n + 3) & ~3


def smem_bytes(W: int, threads: int, tile_cols: int, itemsize: int,
               rolling_shutter: bool) -> int:
    """The block's shared memory (``smem_values`` of the CUDA source)."""
    ks = _K_RS if rolling_shutter else _K_GS
    head = _round4(W * (_PRO_VALUES + threads // 32 * ks))
    return (head + _round4(W * 18 * tile_cols)) * itemsize


def launch_plan(W: int, G: int, itemsize: int,
                rolling_shutter: bool) -> LaunchPlan:
    """Threads and tile width for a (W, G) row of ``itemsize``-byte values.

    Of the block sizes 32..128 (whole warps, no wider than the row) it
    takes the one that keeps most threads resident on an SM under the
    shared-memory limits, the wider on a tie.  Raises ValueError if not
    even a 32-column tile fits one block.
    """
    best = None
    for threads in range(min(MAX_THREADS, -(-G // 32) * 32), 0, -32):
        cols = min(threads, G)
        nbytes = smem_bytes(W, threads, cols, itemsize, rolling_shutter)
        if nbytes > SMEM_BLOCK:
            continue
        blocks = min(SMEM_SM // (nbytes + SMEM_RESERVED), 32,
                     2048 // threads)
        if (best is None
                or threads * blocks > best.threads * best.blocks_per_sm):
            best = LaunchPlan(threads, cols, -(-G // threads), nbytes, blocks)
    if best is None:
        raise ValueError(
            f"W = {W}, G = {G}, {itemsize}-byte values: a 32-column F tile "
            f"does not fit a block's {SMEM_BLOCK} bytes of shared memory")
    return best


def fused_evaluate_assemble_reference(win, pts, ptf, uv, tt, mask, offs,
                                      rsf, intr, *, model: CameraModel,
                                      loss: Loss) -> dict:
    """Plain PyTorch version: same inputs and outputs as the kernel."""
    NR, W = win.shape[0], win.shape[1]
    G = pts.shape[2]
    offs_a = offs.transpose(1, 2).long()                 # (NR, G, L)
    rs = rsf.transpose(1, 2)
    offs_b = offs_a + rs.long()
    rows = torch.arange(NR, device=win.device)[:, None, None]
    sa = win[rows, offs_a]                               # (NR, G, L, 8)
    sb = win[rows, offs_b]
    m = mask.transpose(1, 2)
    ev = banded.evaluate_slots(
        sa[..., :4], sa[..., 4:7], sb[..., :4], sb[..., 4:7], intr,
        pts.transpose(1, 2), uv.permute(0, 3, 2, 1), tt.transpose(1, 2), m,
        sa[..., 7], sb[..., 7], ptf, model, loss)
    w = banded.assemble_windows(ev, offs_a, offs_b, rs, m, W)
    C = w["C"]                                           # (NR, G, 3, 3)
    return {
        "cost": ev.cost,
        "gw": w["gw"],
        "b0": w["b0"].reshape(NR, W, 36),
        "b1": w["b1"].reshape(NR, W, 36),
        "g_pt": w["g_pt"].transpose(1, 2).contiguous(),
        "c6": torch.stack([C[..., p, q] for p, q in C6_PAIRS], dim=1),
        "F": w["F"].permute(0, 2, 3, 4, 1).reshape(NR, W, 18, G),
    }


def _check(win, pts, ptf, uv, tt, mask, offs, rsf, intr):
    NR, W, eight = win.shape
    _, three, G = pts.shape
    L = tt.shape[1]
    dtype = win.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fused kernel takes float32 or float64, got {dtype}")
    want = {"win": (NR, W, 8), "pts": (NR, 3, G), "ptf": (NR, G),
            "uv": (NR, 2, L, G), "tt": (NR, L, G), "mask": (NR, L, G),
            "offs": (NR, L, G), "rsf": (NR, L, G), "intr": (9,)}
    got = {"win": win, "pts": pts, "ptf": ptf, "uv": uv, "tt": tt,
           "mask": mask, "offs": offs, "rsf": rsf, "intr": intr}
    for k, shape in want.items():
        x = got[k]
        if tuple(x.shape) != shape:
            raise ValueError(f"{k}: shape {tuple(x.shape)}, want {shape}")
        if x.device != win.device:
            raise ValueError(f"{k} on {x.device}, win on {win.device}")
        if not x.is_contiguous():
            raise ValueError(f"{k} must be contiguous")
        if x.dtype != (torch.int32 if k == "offs" else dtype):
            raise TypeError(f"{k}: dtype {x.dtype}")
    if G > MAX_G:
        raise ValueError(f"G = {G} > {MAX_G} points per row")
    if W > MAX_WINDOW:
        raise ValueError(f"W = {W} > {MAX_WINDOW}")
    return NR, W, L, G


def _bind(lib, stream: int, win, pts, ptf, uv, tt, mask, offs, rsf, intr,
          model: CameraModel, loss: Loss, with_plan: bool = True):
    """Check the inputs, plan the launch, allocate the outputs and bind
    the library's C entry point for the dtype to them: returns
    ``(launch, out)``, where ``launch()`` enqueues one run into ``out``
    (``cost`` per row) and returns the entry point's error code.
    ``with_plan=False`` leaves the launch plan out of the arguments, for
    a library built from a source older than the plan."""
    NR, W, L, G = _check(win, pts, ptf, uv, tt, mask, offs, rsf, intr)
    plan = launch_plan(W, G, win.element_size(), model.rolling_shutter)
    tail = ([plan.threads, plan.tile_cols, plan.smem_bytes] if with_plan
            else [])
    fn = (lib.rsba_fused_evaluate_assemble_f32
          if win.dtype == torch.float32
          else lib.rsba_fused_evaluate_assemble_f64)
    P = ctypes.c_void_p
    fn.argtypes = ([P] * 9 + [ctypes.c_int] * 8 + [ctypes.c_double] * 2
                   + [P] * 7 + [ctypes.c_int] * len(tail) + [P])
    fn.restype = ctypes.c_int
    empty = lambda *s: torch.empty(s, dtype=win.dtype,  # noqa: E731
                                   device=win.device)
    out = {"cost": empty(NR), "gw": empty(NR, W, 6), "b0": empty(NR, W, 36),
           "b1": empty(NR, W, 36), "g_pt": empty(NR, 3, G),
           "c6": empty(NR, 6, G), "F": empty(NR, W, 18, G)}
    args = [*(x.data_ptr() for x in (win, pts, ptf, uv, tt, mask, offs, rsf,
                                     intr)),
            NR, W, L, G, int(model.rolling_shutter),
            _INTERP[model.rotation_interp], int(model.use_distortion),
            _LOSS[loss.kind], float(model.projection_sign),
            float(loss.scale),
            *(out[k].data_ptr() for k in ("cost", "gw", "b0", "b1", "g_pt",
                                          "c6", "F")),
            *tail, stream]
    return (lambda: fn(*args)), out


def _run(lib, stream: int, *inputs_model_loss) -> dict:
    """One run of the library's kernel on the inputs of ``_bind``; raises
    if the entry point returns an error."""
    launch, out = _bind(lib, stream, *inputs_model_loss)
    rc = launch()
    if rc != 0:
        raise RuntimeError(f"fused_evaluate_assemble launch failed: "
                           f"error {rc}")
    out["cost"] = out["cost"].sum()
    return out


def fused_evaluate_assemble_cuda(win, pts, ptf, uv, tt, mask, offs, rsf,
                                 intr, *, model: CameraModel,
                                 loss: Loss) -> dict:
    """Launch the CUDA kernel; raises unless the tensors are on CUDA."""
    if win.device.type != "cuda":
        raise RuntimeError(
            f"the fused CUDA kernel needs CUDA tensors, got {win.device}")
    from .build import load
    out = _run(load("fused_evaluate_assemble").lib,
               torch.cuda.current_stream(win.device).cuda_stream,
               win, pts, ptf, uv, tt, mask, offs, rsf, intr, model, loss)
    fused_evaluate_assemble_cuda.launches += 1
    return out


#: launches of the CUDA kernel since the last reset (set it to 0 to reset)
fused_evaluate_assemble_cuda.launches = 0


def fused_evaluate_assemble(win, pts, ptf, uv, tt, mask, offs, rsf, intr,
                            *, model: CameraModel, loss: Loss) -> dict:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    impl = (fused_evaluate_assemble_reference if win.device.type == "cpu"
            else fused_evaluate_assemble_cuda)
    return impl(win, pts, ptf, uv, tt, mask, offs, rsf, intr, model=model,
                loss=loss)
