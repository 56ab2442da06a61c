"""Robust loss functions and the Triggs corrector.

Counterpart of ``rsba_tpu/geometry/losses.py``.  A loss ρ maps the
squared residual norm s = ‖r‖² to a robustified cost (total cost
½ Σ ρ(s)); ``correct`` applies the Triggs correction
r̃ = (√ρ′ / (1−α))·r,  J̃ = √ρ′·(J − (α/s)·r rᵀ J).
"""
from __future__ import annotations

import dataclasses

import torch

LOSS_KINDS = ("trivial", "huber", "soft_l1", "cauchy")


@dataclasses.dataclass(frozen=True)
class Loss:
    """Robust loss spec; ``scale`` is the Ceres parameter ``a`` in
    residual units (Huber transitions at ‖r‖ = a)."""
    kind: str = "trivial"
    scale: float = 1.0

    def __post_init__(self):
        if self.kind not in LOSS_KINDS:
            raise ValueError(f"loss kind must be one of {LOSS_KINDS}")
        if self.scale <= 0:
            raise ValueError("loss scale must be positive")

    def evaluate(self, s: torch.Tensor):
        """ρ(s), ρ′(s), ρ″(s) for squared norm s ≥ 0."""
        a2 = self.scale * self.scale
        if self.kind == "trivial":
            return s, torch.ones_like(s), torch.zeros_like(s)
        if self.kind == "huber":
            # s ≤ a²: ρ = s;  s > a²: ρ = 2a√s − a².
            r_ = torch.sqrt(torch.clamp(s, min=a2))
            out = s > a2
            rho = torch.where(out, 2.0 * self.scale * r_ - a2, s)
            rho1 = torch.where(out, self.scale / r_, torch.ones_like(s))
            rho2 = torch.where(out, -0.5 * self.scale / (r_ * s + 1e-30),
                               torch.zeros_like(s))
            return rho, rho1, rho2
        t = 1.0 + s / a2
        if self.kind == "soft_l1":
            sq = torch.sqrt(t)
            return 2.0 * a2 * (sq - 1.0), 1.0 / sq, -0.5 / (a2 * t * sq)
        return a2 * torch.log(t), 1.0 / t, -1.0 / (a2 * t * t)   # cauchy

    def correct(self, r: torch.Tensor, J: torch.Tensor | None):
        """Triggs-correct residual (…, d) and optional Jacobian (…, d, p).

        Returns (r̃, J̃, ρ); the trivial loss returns its inputs.
        """
        s = torch.sum(r * r, dim=-1)
        if self.kind == "trivial":
            return r, J, s
        rho, rho1, rho2 = self.evaluate(s)
        sqrt_rho1 = torch.sqrt(torch.clamp(rho1, min=1e-30))
        d = torch.clamp(1.0 + 2.0 * s * rho2 / rho1, min=0.0)
        alpha = torch.where(rho2 > 0.0, 1.0 - torch.sqrt(d),
                            torch.zeros_like(s))
        res_scale = sqrt_rho1 / (1.0 - alpha)
        r_t = res_scale[..., None] * r
        J_t = None
        if J is not None:
            alpha_over_s = torch.where(
                s > 0, alpha / torch.clamp(s, min=1e-30), torch.zeros_like(s))
            rTJ = torch.einsum("...d,...dp->...p", r, J)
            J_t = sqrt_rho1[..., None, None] * (
                J - alpha_over_s[..., None, None]
                * r[..., :, None] * rTJ[..., None, :])
        return r_t, J_t, rho
