"""Schur-complement helpers — the part of ``rsba_tpu/solver/schur.py`` the
banded solver uses: the Ceres LM diagonal and closed-form inverses of
small symmetric positive definite blocks."""
from __future__ import annotations

import torch

from .options import SolverOptions


def invert_3x3_psd(C: torch.Tensor) -> torch.Tensor:
    """Batched closed-form inverse of symmetric PD 3×3 blocks (…, 3, 3)."""
    a, b, c = C[..., 0, 0], C[..., 0, 1], C[..., 0, 2]
    d, e, f = C[..., 1, 1], C[..., 1, 2], C[..., 2, 2]
    co00 = d * f - e * e
    co01 = c * e - b * f
    co02 = b * e - c * d
    det = a * co00 + b * co01 + c * co02
    inv_det = 1.0 / det
    co11 = a * f - c * c
    co12 = b * c - a * e
    co22 = a * d - b * b
    row0 = torch.stack([co00, co01, co02], dim=-1)
    row1 = torch.stack([co01, co11, co12], dim=-1)
    row2 = torch.stack([co02, co12, co22], dim=-1)
    return (torch.stack([row0, row1, row2], dim=-2)
            * inv_det[..., None, None])


def invert_6x6_psd(M: torch.Tensor) -> torch.Tensor:
    """Batched closed-form inverse of symmetric PD 6×6 blocks (…, 6, 6),
    blocked 2×2-of-3×3 Schur form on top of invert_3x3_psd.  Used for
    preconditioner factors, where its round-off only perturbs the CG
    convergence rate."""
    A = M[..., :3, :3]
    Bt = M[..., :3, 3:]
    C = M[..., 3:, 3:]
    Ai = invert_3x3_psd(A)
    Wb = Ai @ Bt
    Si = invert_3x3_psd(C - Bt.transpose(-1, -2) @ Wb)
    WSi = Wb @ Si
    top = torch.cat([Ai + WSi @ Wb.transpose(-1, -2), -WSi], dim=-1)
    bot = torch.cat([-WSi.transpose(-1, -2), Si], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _lm_scaled_damp(diag: torch.Tensor, radius: float,
                    options: SolverOptions):
    """Ceres LM diagonal: clamp(diag)/radius, dead dims pinned to 1."""
    dead = diag <= 0.0
    lm = torch.clamp(diag, options.min_lm_diagonal,
                     options.max_lm_diagonal) / radius
    return torch.where(dead, torch.ones_like(lm), lm), dead
