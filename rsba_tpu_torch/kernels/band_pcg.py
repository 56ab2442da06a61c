"""PCG on the symmetric block band: CUDA kernel wrapper and its plain version.

The banded Schur engine's solve of S_λ x = b (``solver/banded_fused.py``'s
``solve_step``) with the block-Jacobi preconditioner.  Counterpart of no
TPU kernel: the reference runs ``rsba_tpu/solver/pcg.py::pcg`` as XLA
ops.  Inputs, as ``solver/banded.py::band_rows`` lays the band out:

    rows  (P, 6, 6(2W−1))  pose p's block row of S over its 2W−1 neighbours
    nbr   (P, 2W−1) int64  the pose of each block column
    Minv  (P, 6, 6)        inverses of S's diagonal blocks
    b     (6P,)

Outputs ``(x, r, iters)`` with the meaning of ``solver/pcg.py::pcg``: stop
when ‖r‖ ≤ η‖b‖ or after ``max_iterations`` passes; α and β freeze at 0
when pᵀq ≤ 0 or rᵀz ≤ 0 (‖r‖ then reads −1, which ends the loop);
``iters``, a 0-dim int32 tensor, counts the live passes.

``band_pcg_cuda`` launches the hand-written kernel (``csrc/band_pcg.cu``):
one thread block cluster runs every pass and ends the loop on the device,
so the call stays inside a CUDA graph.  It raises unless the tensors are
on CUDA.  ``band_pcg_reference`` is the plain version, the masked-pass
loop of ``pcg`` over the band's rows; ``band_pcg`` picks the kernel for
CUDA tensors and the plain version for CPU tensors.

Each call opens a host span ``band_pcg.plan`` (``utils/trace.py``) whose
attributes are the band's ``P``, ``W`` and ``itemsize`` and the launch
plan: ``ctas``, ``poses_per_cta``, ``rows_in_smem``, ``smem_bytes``.  On
CUDA it is the plan the wrapper launches, at a capture or eagerly; on the
CPU the plan the card would take first for these shapes (zeros where
none fits).
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..utils import trace

DOF = 6
THREADS = 1024          # a CTA's threads, NT in the CUDA source
CLUSTERS = (16, 8)      # CTAs of the cluster: H100's largest, then portable
SMEM_BLOCK = 232448     # shared memory one block of an H100 may take


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How the kernel's one cluster covers the poses."""
    ctas: int            # the cluster's CTAs
    poses_per_cta: int   # a CTA's poses (the last CTA fewer)
    rows_in_smem: bool   # the CTA's rows kept in shared memory
    smem_bytes: int      # dynamic shared memory of a CTA


def smem_bytes(ppc: int, W: int, itemsize: int, rows_in_smem: bool) -> int:
    """A CTA's shared memory (``smem_bytes`` of the CUDA source): p and z
    over the poses and their halo, q, r, x, the partial sums, the block
    columns' offsets (ints), and the rows where they are kept."""
    state = (2 * (ppc + 2 * (W - 1)) * DOF + 3 * ppc * DOF
             + 3 * (THREADS // 32) + 8)
    head = state * itemsize + ppc * (2 * W - 1) * 4
    if not rows_in_smem:
        return head
    return -(-head // 16) * 16 + ppc * DOF * DOF * (2 * W - 1) * itemsize


def launch_plans(P: int, W: int, itemsize: int) -> list[LaunchPlan]:
    """The plans whose CTAs fit a block's shared memory, best first: the
    larger cluster, then the rows kept in shared memory.  The wrapper takes
    the first that the card can run.  Raises ValueError if none fits."""
    plans = []
    for cluster in CLUSTERS:
        ppc = -(-P // cluster)
        for rows_in_smem in (True, False):
            nbytes = smem_bytes(ppc, W, itemsize, rows_in_smem)
            if nbytes <= SMEM_BLOCK:
                plans.append(LaunchPlan(-(-P // ppc), ppc, rows_in_smem,
                                        nbytes))
    if not plans:
        raise ValueError(
            f"P = {P}, W = {W}, {itemsize}-byte values: a CTA's share of "
            f"the vectors does not fit {SMEM_BLOCK} bytes of shared memory")
    return plans


# --- plain version -----------------------------------------------------------

def band_pcg_reference(rows, nbr, Minv, b, max_iterations: int, eta: float):
    """Plain PyTorch version: ``solver/pcg.py::pcg`` with the band product
    of ``solver/banded.py::make_band_matvec`` and the block-Jacobi
    preconditioner, in the same operations (the same bits)."""
    P = rows.shape[0]

    def matvec(v):
        return torch.bmm(rows, v.reshape(P, DOF)[nbr].reshape(P, -1, 1)
                         ).reshape(-1)

    def precond(v):
        return torch.bmm(Minv, v.reshape(P, DOF, 1)).reshape(-1)

    bnorm = torch.linalg.vector_norm(b)
    tol = eta * bnorm
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    x = torch.zeros_like(b)
    r = b
    p = precond(r)
    rz = torch.dot(r, p)
    rnorm = bnorm
    k = torch.zeros((), dtype=torch.int32, device=b.device)
    for _ in range(max_iterations):
        live = rnorm > tol
        q = matvec(p)
        pq = torch.dot(p, q)
        alpha = torch.where(live & (pq > 0), rz / pq, zero)
        x = torch.addcmul(x, alpha, p)
        r = torch.addcmul(r, alpha, q, value=-1.0)
        z = precond(r)
        rz_new = torch.dot(r, z)
        beta = torch.where(rz > 0, rz_new / rz, zero)
        stalled = torch.logical_or(pq <= 0, rz <= 0)
        rnorm_new = torch.where(stalled, -1.0, torch.linalg.vector_norm(r))
        p = torch.where(live, torch.addcmul(z, beta, p), p)
        rz = torch.where(live, rz_new, rz)
        rnorm = torch.where(live, rnorm_new, rnorm)
        k = k + live.to(torch.int32)
    return x, r, k


# --- the kernel --------------------------------------------------------------

def _check(rows, nbr, Minv, b) -> tuple[int, int]:
    """(P, W) of the inputs; raises on what the kernel does not take."""
    if rows.dim() != 3 or rows.shape[1] != DOF or rows.shape[2] % DOF \
            or (rows.shape[2] // DOF) % 2 == 0 or rows.shape[0] < 1:
        raise ValueError(f"rows: shape {tuple(rows.shape)}, want "
                         "(P, 6, 6(2W-1))")
    P, K = rows.shape[0], rows.shape[2] // DOF
    if b.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"band PCG kernel takes float32 or float64, got "
                        f"{b.dtype}")
    want = {"rows": (P, DOF, K * DOF), "nbr": (P, K), "Minv": (P, DOF, DOF),
            "b": (P * DOF,)}
    got = {"rows": rows, "nbr": nbr, "Minv": Minv, "b": b}
    for k, shape in want.items():
        t = got[k]
        if tuple(t.shape) != shape:
            raise ValueError(f"{k}: shape {tuple(t.shape)}, want {shape}")
        if t.device != b.device:
            raise ValueError(f"{k} on {t.device}, b on {b.device}")
        if not t.is_contiguous():
            raise ValueError(f"{k} must be contiguous")
        if t.dtype != (torch.int64 if k == "nbr" else b.dtype):
            raise TypeError(f"{k}: dtype {t.dtype}")
    return P, (K + 1) // 2


def _entry(lib, dtype):
    """The library's C entry point for ``dtype``, with its argument types."""
    fn = (lib.rsba_band_pcg_f32 if dtype == torch.float32
          else lib.rsba_band_pcg_f64)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ([ptr] * 4 + [i32] * 3 + [ctypes.c_double] + [ptr] * 3
                   + [i32] * 4 + [ptr, ptr])
    fn.restype = i32
    return fn


_PLANS: dict = {}


def _plan(fn, P: int, W: int, dtype, device) -> LaunchPlan:
    """The first of ``launch_plans`` that the card can run, asked once per
    shape (before any capture: a solve's warm-up calls the kernel first)."""
    key = (P, W, dtype, device)
    if key not in _PLANS:
        for plan in launch_plans(P, W, torch.empty((), dtype=dtype)
                                 .element_size()):
            n = ctypes.c_int(0)
            rc = fn(None, None, None, None, P, W, 0, 0.0, None, None, None,
                    plan.ctas, plan.poses_per_cta, int(plan.rows_in_smem),
                    plan.smem_bytes, None, ctypes.byref(n))
            if rc == 0 and n.value >= 1:
                _PLANS[key] = plan
                break
        else:
            raise RuntimeError(f"the card runs none of the band PCG "
                               f"kernel's clusters for P = {P}, W = {W}")
    return _PLANS[key]


def _first_plan(P: int, W: int, itemsize: int):
    """The first of ``launch_plans``, or None where none fits."""
    try:
        return launch_plans(P, W, itemsize)[0]
    except ValueError:
        return None


def _plan_attrs(P: int, W: int, itemsize: int, plan) -> dict:
    """The ``band_pcg.plan`` span's attributes; zeros without a plan."""
    return dict(P=P, W=W, itemsize=itemsize,
                **dataclasses.asdict(plan or LaunchPlan(0, 0, False, 0)))


def band_pcg_cuda(rows, nbr, Minv, b, max_iterations: int, eta: float):
    """Launch the CUDA kernel; raises unless the tensors are on CUDA."""
    if b.device.type != "cuda":
        raise RuntimeError(
            f"the band PCG kernel needs CUDA tensors, got {b.device}")
    P, W = _check(rows, nbr, Minv, b)
    from .build import load
    fn = _entry(load("band_pcg").lib, b.dtype)
    plan = _plan(fn, P, W, b.dtype, b.device)
    with trace.span("band_pcg.plan",
                    **_plan_attrs(P, W, b.element_size(), plan)):
        x, r = torch.empty_like(b), torch.empty_like(b)
        iters = torch.empty((), dtype=torch.int32, device=b.device)
        rc = fn(rows.data_ptr(), nbr.data_ptr(), Minv.data_ptr(),
                b.data_ptr(), P, W, int(max_iterations), float(eta),
                x.data_ptr(), r.data_ptr(), iters.data_ptr(), plan.ctas,
                plan.poses_per_cta, int(plan.rows_in_smem), plan.smem_bytes,
                torch.cuda.current_stream(b.device).cuda_stream, None)
    if rc != 0:
        raise RuntimeError(f"band_pcg launch failed: error {rc}")
    band_pcg_cuda.launches += 1
    return x, r, iters


#: launches of the CUDA kernel since the last reset (set it to 0 to reset)
band_pcg_cuda.launches = 0


def band_pcg(rows, nbr, Minv, b, max_iterations: int, eta: float):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if b.device.type != "cpu":
        return band_pcg_cuda(rows, nbr, Minv, b, max_iterations, eta)
    P, W = rows.shape[0], (rows.shape[2] // DOF + 1) // 2
    itemsize = b.element_size()
    plan = _first_plan(P, W, itemsize) if trace.enabled() else None
    with trace.span("band_pcg.plan", **_plan_attrs(P, W, itemsize, plan)):
        return band_pcg_reference(rows, nbr, Minv, b, max_iterations, eta)
