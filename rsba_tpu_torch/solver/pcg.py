"""Preconditioned conjugate gradients — ``pcg`` of
``rsba_tpu/solver/pcg.py`` as a Python loop on device tensors."""
from __future__ import annotations

import torch


def pcg(matvec, precond, b: torch.Tensor, max_iterations: int, eta: float):
    """Preconditioned CG on S_λ x = b; returns (x, final residual, iters).

    Stopping: ‖r‖ ≤ η‖b‖ (Ceres's per-solve forcing) or max_iterations.
    If the operator loses positive definiteness (pᵀq ≤ 0) or rᵀz ≤ 0,
    α and β freeze at 0 and the loop stops, as in the reference.  The
    stopping test reads one scalar back per iteration.
    """
    bnorm = torch.linalg.vector_norm(b)
    tol = float(eta * bnorm)
    x = torch.zeros_like(b)
    r = b
    p = precond(r)
    rz = torch.dot(r, p)
    rnorm = float(bnorm)
    k = 0
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    while k < max_iterations and rnorm > tol:
        q = matvec(p)
        pq = torch.dot(p, q)
        alpha = torch.where(pq > 0, rz / pq, zero)
        x = x + alpha * p
        r = r - alpha * q
        z = precond(r)
        rz_new = torch.dot(r, z)
        beta = torch.where(rz > 0, rz_new / rz, zero)
        p = z + beta * p
        stalled = torch.logical_or(pq <= 0, rz <= 0)
        rnorm = float(torch.where(stalled, -1.0,
                                  torch.linalg.vector_norm(r)))
        rz = rz_new
        k += 1
    return x, r, k
