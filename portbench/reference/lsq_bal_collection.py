"""The plain float64 reference of a BAL-style problem at a photo
collection's size (``generator_bal_collection``): ``lsq_bal.py``'s data,
residuals, Jacobians, normal equations, cost and statistics, with a
Gauss-Newton step whose reduced camera system is formed point group by
point group.

``lsq_bal._step`` pads every point to the longest track, (M, L_max, 9, 3)
and blocks of (9 L_max)², which at tracks of up to 32 cameras is about
8e10 scattered entries a step.  Here the points are grouped by their
number of observations n, and each group's E_j C_j⁻¹ E_jᵀ is formed at
its own width 9n, in blocks of points of at most ``ENTRY_BLOCK`` entries,
so that a step scatters 81 Σ_j n_j² entries.  The reduced camera system
is the same dense (Dc × Dc) float64 matrix and is factored by Cholesky
(Dc = 16,002 at Venice's size: 2.05 GB, about 1.4e12 FLOP).  Everything
else, and the definitions of ``gn_gain`` (``gauss_newton_gain``), the
cost and the inlier RMSE (``cost_stats``), are ``lsq_bal``'s.

Plain ``torch`` only: it imports no kernel of the program, nothing of
``rsba_tpu_torch`` and no JAX.
"""
from __future__ import annotations

import torch

from .lsq_bal import (CAM, Data, _apply, _normal_equations, cost_stats,
                      params_on)

__all__ = ["Data", "params_on", "cost_stats", "gauss_newton_gain",
           "optimum"]

#: the most entries of E_j C_j⁻¹ E_jᵀ blocks formed and scattered at once
ENTRY_BLOCK = 1 << 24


def _point_groups(d: Data) -> list:
    """For each number of observations n > 0 that a point has: the points
    with n observations (m,) and their observations (m, n), in
    observation order."""
    order = torch.argsort(d.ip, stable=True)
    counts = torch.bincount(d.ip, minlength=d.n_points)
    first = torch.cumsum(counts, 0) - counts
    groups = []
    for n in torch.unique(counts).tolist():
        if n == 0:
            continue
        pts = torch.nonzero(counts == n)[:, 0]
        obs = order[first[pts][:, None]
                    + torch.arange(n, device=pts.device)[None, :]]
        groups.append((pts, obs))
    return groups


def _step(d: Data, ne, groups: list, lam: float):
    """The damped Gauss-Newton step (dc (Dc,), dx (M, 3)), or None where
    the reduced system is not positive definite (``lsq_bal._step``'s
    system, damping and masks)."""
    B, g_c, C, g_x, E, rows = ne
    eye3 = torch.eye(3, dtype=C.dtype, device=C.device)
    Cd = C + lam * torch.diag_embed(torch.diagonal(C, dim1=1, dim2=2)) \
        + 1e-12 * eye3
    Ci = torch.linalg.inv(Cd)
    S = B.clone()
    S.diagonal().add_(lam * torch.clamp(torch.diagonal(B), min=1e-12))
    Cg = torch.einsum("mij,mj->mi", Ci, g_x)
    rhs = (-g_c).index_add(
        0, rows.reshape(-1),
        torch.einsum("nia,na->ni", E, Cg[d.ip]).reshape(-1))
    for pts, obs in groups:
        n = obs.shape[1]
        step = max(ENTRY_BLOCK // (CAM * n) ** 2, 1)
        for lo in range(0, pts.shape[0], step):
            o = obs[lo:lo + step]
            e = E[o].reshape(-1, n * CAM, 3)
            K = torch.einsum("mia,mab,mjb->mij", e, Ci[pts[lo:lo + step]], e)
            r_ = rows[o].reshape(-1, n * CAM)
            S.index_put_((r_[:, :, None].expand_as(K),
                          r_[:, None, :].expand_as(K)), -K, accumulate=True)
            del e, K, r_
    m = torch.cat([torch.repeat_interleave(d.pose_free, 6),
                   torch.ones(3 * d.n_intr, dtype=S.dtype,
                              device=S.device)])
    S.mul_(m[:, None]).mul_(m[None, :])
    S.diagonal().add_(1.0 - m)
    rhs = rhs * m
    L_, info = torch.linalg.cholesky_ex(S)
    del S
    if int(info) != 0:
        return None
    dc = torch.cholesky_solve(rhs[:, None], L_)[:, 0]
    del L_
    back = torch.zeros_like(g_x)
    back.index_add_(0, d.ip, torch.einsum("nia,ni->na", E, dc[rows]))
    dx = -torch.einsum("mij,mj->mi", Ci, g_x + back)
    return dc, dx


def gauss_newton_gain(d: Data, p: dict, lam: float = 1e-9) -> dict:
    """``lsq_bal.gauss_newton_gain`` with this module's step: the decrease
    a float64 Gauss-Newton step from ``p`` predicts, ½ gᵀ H⁻¹ g, zero at
    a stationary point."""
    ne = _normal_equations(d, p)
    groups = _point_groups(d)
    while (step := _step(d, ne, groups, lam)) is None:
        lam *= 10.0
    dc, dx = step
    _, g_c, _, g_x, _, _ = ne
    return {"gain": -0.5 * float(torch.dot(g_c, dc) + torch.sum(g_x * dx)),
            "lambda": lam}


def optimum(d: Data, p: dict, rtol: float = 1e-13, max_steps: int = 30,
            lam: float = 1e-6, log=None) -> tuple[dict, dict]:
    """``lsq_bal.optimum`` (``lsq.optimum``'s Levenberg-Marquardt rules)
    with this module's step."""
    groups = _point_groups(d)
    cost = cost_stats(d, p)["cost"]
    steps = 0
    for _ in range(max_steps):
        ne = _normal_equations(d, p)
        while lam < 1e12:
            step = _step(d, ne, groups, lam)
            if step is not None:
                cand = _apply(d, p, *step)
                new = cost_stats(d, cand)["cost"]
                if new < cost:
                    break
            lam *= 10.0
        else:
            break
        steps += 1
        decrease = cost - new
        if log is not None:
            log(f"step {steps} cost {new!r} decrease {decrease:.3e} "
                f"lambda {lam:.1e}")
        p, cost = cand, new
        if decrease <= rtol * cost and lam <= 1e-4:
            break
        lam = max(lam / 10.0, 1e-12)
    out = cost_stats(d, p)
    out["steps"] = steps
    return p, out
