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
other.  The plain PyTorch version lives here too:
``fused_evaluate_assemble_reference``, built on ``evaluate_slots``
(residuals and Jacobians by ``torch.func.jacfwd`` + ``vmap``) and
``assemble_windows`` (the window sums).  ``fused_evaluate_assemble``
picks the kernel for CUDA tensors and the plain version for CPU tensors.

The kernel runs one block per window row, one thread per point column,
and keeps the row's (W, 18, columns) tile of F in shared memory.
``launch_plan`` chooses the block's threads and the tile's width from the
shape: the whole row where it has at most 128 columns and its tile fits,
else the same kernel walks the row in column chunks.  It is one kernel
for every shape; a shape it cannot take raises.

The residual pass, ``residual_pass``, is the second kernel of the same
source: on a candidate's parameters it computes every slot's robust cost
ρ (NR, L, G), 0 on padded slots, and the pairwise decrease
½ Σ_valid (ρ_ref − ρ) against the loop-carried ρ_ref, from the fused
kernel's inputs less ``ptf``.  ``residual_pass_cuda`` launches it on CUDA
tensors and raises on any other, ``residual_pass_reference`` is its plain
version (``camera.project`` and the loss on the kernel's layout), and
``residual_pass`` picks between them by device as
``fused_evaluate_assemble`` does.  ``residual_plan`` chooses the rows a
block and its threads from the shape.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import torch

from ..geometry import CameraModel, Loss, camera
from ..geometry import quaternion as quat
from ..problem.types import POSE_DOF

#: symmetric 3×3 component order in c6 packing
C6_PAIRS = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
#: diagonal component positions within the c6 packing
C6_DIAG = (0, 3, 5)

_INTERP = {"slerp": 0, "nlerp": 1, "lerp_aa": 2}
_LOSS = {"trivial": 0, "huber": 1, "soft_l1": 2, "cauchy": 3}
MAX_G = 1024   # points per row
MAX_W = 24     # poses per window

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


# --- plain version -----------------------------------------------------------

class WEvaluation(NamedTuple):
    """Triggs-corrected residuals + block Jacobians in window layout."""
    r: torch.Tensor      # (NR, G, L, 2)
    cost: torch.Tensor   # scalar
    J_pa: torch.Tensor   # (NR, G, L, 2, 6)
    J_pb: torch.Tensor   # (NR, G, L, 2, 6)
    J_pt: torch.Tensor   # (NR, G, L, 2, 3)


def evaluate_slots(qa, ca, qb, cb, intr, X, uv, t, mask, pf_a, pf_b, ptf,
                   model: CameraModel, loss: Loss) -> WEvaluation:
    """Residuals + tangent Jacobians for every slot of an (NR, G, L) grid.

    qa/qb (NR, G, L, 4), ca/cb (NR, G, L, 3), intr (9,), X (NR, G, 3),
    uv (NR, G, L, 2), t/mask/pf_a/pf_b (NR, G, L), ptf (NR, G).

    Masking: only slots with mask > 0 are evaluated, and the rest get
    zero r/J (padded slots can project to NaN); pose/point free masks
    zero J columns (constant blocks).
    """
    grid = tuple(t.shape)
    dtype = t.dtype

    def f(d_pa, d_pb, d_pt, qa, ca, qb, cb, intr, X, uv, t):
        qa2 = quat.boxplus(qa, d_pa[:3])
        qb2 = quat.boxplus(qb, d_pb[:3])
        r = camera.project(qa2, ca + d_pa[3:], qb2, cb + d_pb[3:], intr,
                           X + d_pt, t, model) - uv
        return r, r

    zeros = (torch.zeros(POSE_DOF, dtype=dtype, device=t.device),
             torch.zeros(POSE_DOF, dtype=dtype, device=t.device),
             torch.zeros(3, dtype=dtype, device=t.device))

    def one(qa, ca, qb, cb, intr, X, uv, t):
        J, r = torch.func.jacfwd(f, argnums=(0, 1, 2), has_aux=True)(
            *zeros, qa, ca, qb, cb, intr, X, uv, t)
        return r, torch.cat(J, dim=-1)

    S = t.numel()
    idx = torch.nonzero(mask.reshape(S) > 0).squeeze(1)   # valid slots
    flat = lambda a: a.reshape((S,) + tuple(a.shape[3:]))[idx]  # noqa: E731
    Xs = X[:, :, None, :].expand(grid + (3,))
    if idx.numel() > 0:
        r, J = torch.func.vmap(one, in_dims=(0, 0, 0, 0, None, 0, 0, 0))(
            flat(qa), flat(ca), flat(qb), flat(cb), intr, flat(Xs),
            flat(uv), flat(t))                      # (V, 2), (V, 2, 15)
    else:   # padding rows only (a block of a sharded solve)
        r, J = t.new_zeros((0, 2)), t.new_zeros((0, 2, 2 * POSE_DOF + 3))

    r, J, rho = loss.correct(r, J)
    cost = 0.5 * torch.sum(rho)
    rt = r.new_zeros((S, 2)).index_copy_(0, idx, r)
    Jt = J.new_zeros((S, 2, J.shape[-1])).index_copy_(0, idx, J)
    J_pa, J_pb, J_pt = torch.split(Jt, [POSE_DOF, POSE_DOF, 3], dim=-1)
    J_pa = J_pa.reshape(grid + (2, POSE_DOF)) * pf_a[..., None, None]
    J_pb = J_pb.reshape(grid + (2, POSE_DOF)) * pf_b[..., None, None]
    J_pt = J_pt.reshape(grid + (2, 3)) * ptf[:, :, None, None, None]
    return WEvaluation(r=rt.reshape(grid + (2,)), cost=cost, J_pa=J_pa,
                       J_pb=J_pb, J_pt=J_pt)


def _window_sum(v: torch.Tensor, offs: torch.Tensor, W: int,
                per_point: bool = False) -> torch.Tensor:
    """Sum slot values (NR, G, L, ...) into their W-window slot:
    → (NR, W, ...), or (NR, G, W, ...) with ``per_point``."""
    NR, G, L = offs.shape
    rest = tuple(v.shape[3:])
    if per_point:
        base = torch.arange(NR * G, device=offs.device).reshape(NR, G, 1)
        n_out = NR * G * W
    else:
        base = torch.arange(NR, device=offs.device).reshape(NR, 1, 1)
        n_out = NR * W
    idx = (base * W + offs).reshape(-1)
    out = v.new_zeros((n_out,) + rest)
    out.index_add_(0, idx, v.reshape((-1,) + rest))
    return out.reshape(((NR, G, W) if per_point else (NR, W)) + rest)


def assemble_windows(ev: WEvaluation, offs_a: torch.Tensor,
                     offs_b: torch.Tensor, rs_ab: torch.Tensor,
                     mask: torch.Tensor, W: int) -> dict:
    """One pass over window-layout Jacobians → per-row window sums (not
    yet folded into poses) and per-point blocks:

    gw (NR, W, 6), b0/b1 (NR, W, 6, 6) band d=0/d=1 windows,
    g_pt (NR, G, 3), C (NR, G, 3, 3), F (NR, G, W, 6, 3).
    """
    m = mask[..., None]
    r, Ja, Jb, Jp = ev.r, ev.J_pa, ev.J_pb, ev.J_pt
    ta = torch.einsum("sglr,sglra->sgla", r, Ja)
    tb = torch.einsum("sglr,sglra->sgla", r, Jb)
    gw = (_window_sum(ta * m, offs_a, W) + _window_sum(tb * m, offs_b, W))
    g_pt = torch.einsum("sglr,sglrp->sgp", r, Jp)
    C = torch.einsum("sglrp,sglrq->sgpq", Jp, Jp)
    m5 = m[..., None]
    fa = torch.einsum("sglra,sglrp->sglap", Ja, Jp) * m5
    fb = torch.einsum("sglra,sglrp->sglap", Jb, Jp) * m5
    F = (_window_sum(fa, offs_a, W, per_point=True)
         + _window_sum(fb, offs_b, W, per_point=True))
    aa = torch.einsum("sglra,sglrb->sglab", Ja, Ja) * m5
    bb = torch.einsum("sglra,sglrb->sglab", Jb, Jb) * m5
    ab = torch.einsum("sglra,sglrb->sglab", Ja, Jb) * m5
    same = (1.0 - rs_ab)[..., None, None]            # pose_b == pose_a
    adj = rs_ab[..., None, None]                     # pose_b == pose_a + 1
    x0 = _window_sum(ab * same, offs_a, W)
    b0 = (_window_sum(aa, offs_a, W) + _window_sum(bb, offs_b, W)
          + x0 + x0.transpose(-1, -2))
    b1 = _window_sum(ab * adj, offs_a, W)
    return {"gw": gw, "b0": b0, "b1": b1, "g_pt": g_pt, "C": C, "F": F}


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
    ev = evaluate_slots(
        sa[..., :4], sa[..., 4:7], sb[..., :4], sb[..., 4:7], intr,
        pts.transpose(1, 2), uv.permute(0, 3, 2, 1), tt.transpose(1, 2), m,
        sa[..., 7], sb[..., 7], ptf, model, loss)
    w = assemble_windows(ev, offs_a, offs_b, rs, m, W)
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
        if x is None and k == "ptf":      # the residual pass takes none
            continue
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
    if W > MAX_W:
        raise ValueError(f"W = {W} > {MAX_W}")
    return NR, W, L, G


def _bind(lib, stream: int, win, pts, ptf, uv, tt, mask, offs, rsf, intr,
          model: CameraModel, loss: Loss):
    """Check the inputs, plan the launch, allocate the outputs and bind
    the library's C entry point for the dtype to them: returns
    ``(launch, out)``, where ``launch()`` enqueues one run into ``out``
    (``cost`` per row) and returns the entry point's error code."""
    NR, W, L, G = _check(win, pts, ptf, uv, tt, mask, offs, rsf, intr)
    plan = launch_plan(W, G, win.element_size(), model.rolling_shutter)
    tail = [plan.threads, plan.tile_cols, plan.smem_bytes]
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


# --- the residual pass ------------------------------------------------------

#: streaming multiprocessors of an H100 SXM
SMS = 132
RESIDUAL_MAX_THREADS = 256
#: shared memory a residual block may take without opting in (bytes)
RESIDUAL_SMEM_BLOCK = 48 * 1024


@dataclasses.dataclass(frozen=True)
class ResidualPlan:
    """How the residual kernel covers the grid."""
    threads: int         # per block
    rows_per_block: int  # consecutive rows a block takes
    blocks: int
    smem_bytes: int      # the rows' prologues and one partial a thread


def residual_smem_bytes(W: int, rows: int, threads: int,
                        itemsize: int) -> int:
    """A residual block's shared memory (``residual_smem_values`` of the
    CUDA source)."""
    return (_round4(rows * W * _PRO_VALUES) + threads) * itemsize


def residual_plan(NR: int, W: int, G: int, itemsize: int) -> ResidualPlan:
    """Rows a block and threads for an (NR, ·, G) grid of W-pose windows.

    A block takes R consecutive rows and a thread one column of one of
    them (R·G columns rounded up to whole warps); a row wider than
    ``RESIDUAL_MAX_THREADS`` columns takes a block of its own, whose
    threads walk its columns.  Of the R whose prologues fit
    ``RESIDUAL_SMEM_BLOCK`` and that leave at least four blocks an SM (or
    NR blocks, on a smaller grid), it takes the one with the fewest idle
    lanes, the larger on a tie.
    """
    def plan(rows, threads):
        return ResidualPlan(threads, rows, -(-NR // rows),
                            residual_smem_bytes(W, rows, threads, itemsize))

    if G > RESIDUAL_MAX_THREADS:
        return plan(1, RESIDUAL_MAX_THREADS)
    want_blocks = min(4 * SMS, NR)
    best, best_key = None, None
    for rows in range(1, RESIDUAL_MAX_THREADS // G + 1):
        threads = -(-rows * G // 32) * 32
        p = plan(rows, threads)
        if rows > 1 and (p.smem_bytes > RESIDUAL_SMEM_BLOCK
                         or p.blocks < want_blocks):
            continue
        key = ((threads - rows * G) / threads, -rows)
        if best_key is None or key < best_key:
            best, best_key = p, key
    return best


def residual_pass_reference(win, pts, uv, tt, mask, offs, rsf, intr,
                            rho_ref, *, model: CameraModel, loss: Loss):
    """Plain PyTorch version: (ρ (NR, L, G), ½ Σ_valid (ρ_ref − ρ)) on the
    kernel's layout; ``rho_ref`` None counts as zeros."""
    NR = win.shape[0]
    offs_a = offs.long()                                 # (NR, L, G)
    offs_b = offs_a + rsf.long()
    rows = torch.arange(NR, device=win.device)[:, None, None]
    sa = win[rows, offs_a]                               # (NR, L, G, 8)
    sb = win[rows, offs_b]
    X = pts.transpose(1, 2)[:, None]                     # (NR, 1, G, 3)
    proj = camera.project(sa[..., :4], sa[..., 4:7], sb[..., :4],
                          sb[..., 4:7], intr, X, tt, model)
    r = proj - uv.permute(0, 2, 3, 1)
    rho, _, _ = loss.evaluate(torch.sum(r * r, dim=-1))
    # Selection, not multiplication: a padded slot's sentinel point can
    # project to 0/0.
    valid = mask > 0
    rho = torch.where(valid, rho, 0.0)
    ref = rho.new_zeros(()) if rho_ref is None else rho_ref
    return rho, 0.5 * torch.sum(torch.where(valid, ref - rho, 0.0))


def _check_residual(win, pts, uv, tt, mask, offs, rsf, intr, rho_ref):
    NR, W, L, G = _check(win, pts, None, uv, tt, mask, offs, rsf, intr)
    if rho_ref is not None and (
            tuple(rho_ref.shape) != (NR, L, G)
            or rho_ref.device != win.device or rho_ref.dtype != win.dtype
            or not rho_ref.is_contiguous()):
        raise ValueError(f"rho_ref: {tuple(rho_ref.shape)} {rho_ref.dtype} "
                         f"on {rho_ref.device}, want a contiguous "
                         f"{(NR, L, G)} {win.dtype} on {win.device}")
    return NR, W, L, G


def _bind_residual(lib, stream: int, win, pts, uv, tt, mask, offs, rsf,
                   intr, rho_ref, model: CameraModel, loss: Loss):
    """As ``_bind``, for the residual pass: returns ``(launch, out)`` with
    ``out`` holding ``rho`` (NR, L, G) and ``dec`` (NR) row partials."""
    NR, W, L, G = _check_residual(win, pts, uv, tt, mask, offs, rsf, intr,
                                  rho_ref)
    plan = residual_plan(NR, W, G, win.element_size())
    tail = [plan.threads, plan.rows_per_block, plan.smem_bytes]
    fn = (lib.rsba_residual_pass_f32 if win.dtype == torch.float32
          else lib.rsba_residual_pass_f64)
    P = ctypes.c_void_p
    fn.argtypes = ([P] * 9 + [ctypes.c_int] * 8 + [ctypes.c_double] * 2
                   + [P] * 2 + [ctypes.c_int] * len(tail) + [P])
    fn.restype = ctypes.c_int
    out = {"rho": torch.empty((NR, L, G), dtype=win.dtype,
                              device=win.device),
           "dec": torch.empty((NR,), dtype=win.dtype, device=win.device)}
    args = [*(x.data_ptr() for x in (win, pts, uv, tt, mask, offs, rsf,
                                     intr)),
            None if rho_ref is None else rho_ref.data_ptr(),
            NR, W, L, G, int(model.rolling_shutter),
            _INTERP[model.rotation_interp], int(model.use_distortion),
            _LOSS[loss.kind], float(model.projection_sign),
            float(loss.scale), out["rho"].data_ptr(), out["dec"].data_ptr(),
            *tail, stream]
    return (lambda: fn(*args)), out


def _run_residual(lib, stream: int, *inputs_model_loss) -> dict:
    """One run of the library's residual pass on the inputs of
    ``_bind_residual``; raises if the entry point returns an error."""
    launch, out = _bind_residual(lib, stream, *inputs_model_loss)
    rc = launch()
    if rc != 0:
        raise RuntimeError(f"residual pass launch failed: error {rc}")
    return out


def residual_pass_cuda(win, pts, uv, tt, mask, offs, rsf, intr, rho_ref,
                       *, model: CameraModel, loss: Loss):
    """Launch the CUDA residual pass; raises unless the tensors are on
    CUDA.  Returns (ρ, decrease), the decrease the NR row partials summed
    in a fixed order."""
    if win.device.type != "cuda":
        raise RuntimeError(
            f"the residual CUDA kernel needs CUDA tensors, got {win.device}")
    from .build import load
    out = _run_residual(load("fused_evaluate_assemble").lib,
                        torch.cuda.current_stream(win.device).cuda_stream,
                        win, pts, uv, tt, mask, offs, rsf, intr, rho_ref,
                        model, loss)
    residual_pass_cuda.launches += 1
    return out["rho"], out["dec"].sum()


#: launches of the CUDA residual pass since the last reset (set it to 0 to
#: reset)
residual_pass_cuda.launches = 0


def residual_pass(win, pts, uv, tt, mask, offs, rsf, intr, rho_ref, *,
                  model: CameraModel, loss: Loss):
    """The residual kernel for CUDA tensors, the plain version for CPU
    tensors."""
    impl = (residual_pass_reference if win.device.type == "cpu"
            else residual_pass_cuda)
    return impl(win, pts, uv, tt, mask, offs, rsf, intr, rho_ref,
                model=model, loss=loss)
