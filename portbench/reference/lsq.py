"""The plain float64 reference of a bundle-adjustment problem: residuals,
the robust cost, reprojection statistics, and the optimum.

``Data`` holds a scene's observations as float64 tensors on one device;
given another ``dtype`` (the control's bfloat16), the residuals and
Jacobians are computed in it, and everything after them in float64.
``cost_stats`` gives, for any parameters, the cost ½ Σ ρ(‖r‖²) and the
RMSE over all valid observations and over the inliers (‖r‖ ≤ 3 a under
the Huber loss of scale a, all of them under the trivial loss).
``optimum`` minimises the cost from a given start by Levenberg-Marquardt
on iteratively reweighted Gauss-Newton steps (weights ρ'(‖r‖²)): the Jacobians by forward
differentiation of ``geometry.project``, the points eliminated by the
Schur complement, and the reduced camera system factored dense by
Cholesky.  Its fixed point is a stationary point of the cost, and it
stops when an accepted step lowers the cost by less than ``rtol`` of it;
its parameters are held in the data's dtype between steps.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.func import jacfwd, vmap

from . import geometry as geo

#: observations per block of the Jacobian pass, and points per block of
#: the Schur complement
OBS_BLOCK = 1 << 17
POINT_BLOCK = 16384


@dataclasses.dataclass
class Data:
    uv: torch.Tensor
    t: torch.Tensor
    ia: torch.Tensor       # int64
    ib: torch.Tensor
    ip: torch.Tensor
    intr: torch.Tensor     # (9,)
    pose_free: torch.Tensor
    n_poses: int
    n_points: int
    model: dict
    loss: dict

    @staticmethod
    def of(scene, device, dtype=torch.float64) -> "Data":
        """The valid observations of a ``generator.Scene``; the model's
        inputs (pixels, row times, intrinsics) in ``dtype``."""
        m = scene.mask > 0
        f = lambda a, dt=dtype: torch.as_tensor(np.asarray(a), dtype=dt,  # noqa: E731
                                                device=device)
        i = lambda a: torch.as_tensor(np.asarray(a)[m], dtype=torch.int64,  # noqa: E731
                                      device=device)
        return Data(uv=f(scene.uv[m]), t=f(scene.t[m]), ia=i(scene.pose_a),
                    ib=i(scene.pose_b), ip=i(scene.point),
                    intr=f(scene.intr[0]),
                    pose_free=f(scene.pose_free, torch.float64),
                    n_poses=scene.n_poses, n_points=scene.n_points,
                    model=scene.model, loss=scene.loss)

    @property
    def n_obs(self) -> int:
        return self.uv.shape[0]


def params_on(params: dict, device, dtype=torch.float64) -> dict:
    """q, c, points (arrays or tensors) as ``dtype`` tensors on
    ``device``."""
    return {k: torch.as_tensor(params[k]).to(device=device, dtype=dtype)
            for k in ("q", "c", "points")}


def residuals(d: Data, p: dict) -> torch.Tensor:
    """Residuals (n, 2), computed in the data's dtype, in float64."""
    return (geo.project(p["q"][d.ia], p["c"][d.ia], p["q"][d.ib],
                        p["c"][d.ib], d.intr, p["points"][d.ip], d.t,
                        d.model) - d.uv).double()


def _rho(d: Data, s: torch.Tensor):
    if d.loss["kind"] == "trivial":
        return s, torch.ones_like(s)
    if d.loss["kind"] != "huber":
        raise ValueError(f"loss {d.loss['kind']!r} has no reference")
    return geo.huber(s, float(d.loss["scale"]))


def inlier_threshold(d: Data) -> float:
    return (math.inf if d.loss["kind"] == "trivial"
            else 3.0 * float(d.loss["scale"]))


def cost_stats(d: Data, p: dict) -> dict:
    """cost, rmse and inlier rmse (px) at ``p``, and the largest ‖r‖."""
    r = residuals(d, p)
    s = torch.sum(r * r, dim=-1)
    rho, _ = _rho(d, s)
    inl = s <= inlier_threshold(d) ** 2
    n = max(d.n_obs, 1)
    return {"cost": 0.5 * float(torch.sum(rho)),
            "rmse": math.sqrt(float(torch.sum(s)) / n),
            "rmse_inlier": math.sqrt(float(torch.sum(s[inl]))
                                     / max(int(inl.sum()), 1)),
            "max_px": float(torch.sqrt(s.max())) if d.n_obs else 0.0}


def _jacobians(d: Data, p: dict, lo: int, hi: int):
    """Residuals (n, 2) and Jacobians (n, 2, 15) of observations [lo, hi)
    in the tangent [dθ_a, dc_a, dθ_b, dc_b, dX]."""
    ia, ib, ip = d.ia[lo:hi], d.ib[lo:hi], d.ip[lo:hi]
    model, intr = d.model, d.intr

    def r(xi, qa, ca, qb, cb, X, t, uv):
        return geo.project(geo.boxplus(qa, xi[0:3]), ca + xi[3:6],
                           geo.boxplus(qb, xi[6:9]), cb + xi[9:12], intr,
                           X + xi[12:15], t, model) - uv

    args = (p["q"][ia], p["c"][ia], p["q"][ib], p["c"][ib],
            p["points"][ip], d.t[lo:hi], d.uv[lo:hi])
    zero = torch.zeros((hi - lo, 15), dtype=d.uv.dtype, device=d.uv.device)
    res = vmap(r)(zero, *args)
    jac = vmap(jacfwd(r))(zero, *args)
    return res.double(), jac.double()


def _normal_equations(d: Data, p: dict):
    """B (6P, 6P), g_c (6P,), C (M, 3, 3), g_x (M, 3), E (N, 12, 3) and the
    camera rows (N, 12) of each observation, with constant poses'
    columns zeroed; the IRLS weights are ρ'(‖r‖²)."""
    P6, M, N = 6 * d.n_poses, d.n_points, d.n_obs
    dev = d.uv.device
    B = torch.zeros((P6, P6), dtype=torch.float64, device=dev)
    g_c = torch.zeros(P6, dtype=torch.float64, device=dev)
    C = torch.zeros((M, 3, 3), dtype=torch.float64, device=dev)
    g_x = torch.zeros((M, 3), dtype=torch.float64, device=dev)
    E = torch.empty((N, 12, 3), dtype=torch.float64, device=dev)
    k = torch.arange(6, device=dev)
    rows = torch.cat([6 * d.ia[:, None] + k, 6 * d.ib[:, None] + k], dim=1)
    if not d.model["rolling_shutter"]:
        rows[:, 6:] = rows[:, :6]
    for lo in range(0, N, OBS_BLOCK):
        hi = min(lo + OBS_BLOCK, N)
        r, J = _jacobians(d, p, lo, hi)
        _, w = _rho(d, torch.sum(r * r, dim=-1))
        free = torch.cat([d.pose_free[d.ia[lo:hi]][:, None].expand(-1, 6),
                          d.pose_free[d.ib[lo:hi]][:, None].expand(-1, 6)],
                         dim=1)
        Jc = J[:, :, :12] * free[:, None, :]
        if not d.model["rolling_shutter"]:
            Jc[:, :, 6:] = 0.0
        Jx = J[:, :, 12:]
        wJc = w[:, None, None] * Jc
        wr = w[:, None] * r
        rw = rows[lo:hi]
        B.index_put_((rw[:, :, None].expand(-1, 12, 12),
                      rw[:, None, :].expand(-1, 12, 12)),
                     torch.einsum("nki,nkj->nij", wJc, Jc), accumulate=True)
        g_c.index_add_(0, rw.reshape(-1),
                       torch.einsum("nki,nk->ni", Jc, wr).reshape(-1))
        ip = d.ip[lo:hi]
        C.index_add_(0, ip, torch.einsum("nki,nkj->nij",
                                         w[:, None, None] * Jx, Jx))
        g_x.index_add_(0, ip, torch.einsum("nki,nk->ni", Jx, wr))
        E[lo:hi] = torch.einsum("nki,nkj->nij", wJc, Jx)
    return B, g_c, C, g_x, E, rows


def _point_blocks(d: Data):
    """Each point's first pose (M,) and the slot of each observation's two
    poses in the point's run of poses (N, 2): a point's observations touch
    the poses base .. base + span − 1."""
    big = torch.iinfo(torch.int64).max
    lo = torch.full((d.n_points,), big, dtype=torch.int64,
                    device=d.ip.device)
    lo.scatter_reduce_(0, d.ip, torch.minimum(d.ia, d.ib), "amin")
    base = torch.where(lo == big, 0, lo)
    slot = torch.stack([d.ia, d.ib], dim=1) - base[d.ip][:, None]
    return base, slot


def _step(d, ne, blocks, lam):
    """The damped Gauss-Newton step (dc (P, 6), dx (M, 3)) and the decrease
    the model predicts for it, or None where the reduced system is not
    positive definite."""
    B, g_c, C, g_x, E, rows = ne
    base, slot = blocks
    P6, M = B.shape[0], C.shape[0]
    span = int(slot.max()) + 1
    eye3 = torch.eye(3, dtype=C.dtype, device=C.device)
    Cd = C + lam * torch.diag_embed(torch.diagonal(C, dim1=1, dim2=2)) \
        + 1e-12 * eye3
    Ci = torch.linalg.inv(Cd)
    # The reduced system on the poses padded by one run, cropped after.
    n6 = P6 + 6 * span
    S = torch.zeros((n6, n6), dtype=B.dtype, device=B.device)
    S[:P6, :P6] = B + lam * torch.diag(torch.clamp(torch.diagonal(B),
                                                   min=1e-12))
    Cg = torch.einsum("mij,mj->mi", Ci, g_x)
    rhs = (-g_c).index_add(
        0, rows.reshape(-1),
        torch.einsum("nia,na->ni", E, Cg[d.ip]).reshape(-1))
    # Each point's E as one (6 span × 3) block over its run of poses.
    El = torch.zeros((M, span, 6, 3), dtype=E.dtype, device=E.device)
    el = El.view(M * span, 6, 3)
    el.index_add_(0, d.ip * span + slot[:, 0], E[:, :6])
    if d.model["rolling_shutter"]:
        el.index_add_(0, d.ip * span + slot[:, 1], E[:, 6:])
    k = torch.arange(6 * span, device=B.device)
    for lo in range(0, M, POINT_BLOCK):
        e = El[lo:lo + POINT_BLOCK].reshape(-1, 6 * span, 3)
        K = torch.einsum("mia,mab,mjb->mij", e, Ci[lo:lo + POINT_BLOCK], e)
        r_ = 6 * base[lo:lo + POINT_BLOCK, None] + k       # (m, 6 span)
        S.index_put_((r_[:, :, None].expand_as(K),
                      r_[:, None, :].expand_as(K)), -K, accumulate=True)
    S = S[:P6, :P6]
    m = torch.repeat_interleave(d.pose_free, 6)
    S = S * m[:, None] * m[None, :] + torch.diag(1.0 - m)
    rhs = rhs * m
    L_, info = torch.linalg.cholesky_ex(S)
    if int(info) != 0:
        return None
    dc = torch.cholesky_solve(rhs[:, None], L_)[:, 0]
    back = torch.zeros((M, 3), dtype=S.dtype, device=S.device)
    back.index_add_(0, d.ip, torch.einsum("nia,ni->na", E, dc[rows]))
    dx = -torch.einsum("mij,mj->mi", Ci, g_x + back)
    return dc.reshape(-1, 6), dx


def _apply(p, dc, dx):
    """The step applied in float64, the result in the parameters' dtype."""
    dt = p["q"].dtype
    q, c, x = (p[k].double() for k in ("q", "c", "points"))
    return {"q": geo.boxplus(q, dc[:, :3]).to(dt),
            "c": (c + dc[:, 3:]).to(dt), "points": (x + dx).to(dt)}


def gauss_newton_gain(d: Data, p: dict, lam: float = 1e-9) -> dict:
    """What a float64 Gauss-Newton step from ``p`` could still gain: the
    decrease its model predicts, ½ gᵀ H⁻¹ g (H damped by ``lam`` of its
    diagonal, raised tenfold where the factorisation fails), zero at a
    stationary point.  Under the Huber loss the reweighted model lies
    above the cost, so the cost can fall at least this far along the
    step, to first order in the step."""
    ne = _normal_equations(d, p)
    blocks = _point_blocks(d)
    while (step := _step(d, ne, blocks, lam)) is None:
        lam *= 10.0
    dc, dx = step
    _, g_c, _, g_x, _, _ = ne
    return {"gain": -0.5 * float(torch.dot(g_c, dc.reshape(-1))
                                 + torch.sum(g_x * dx)),
            "lambda": lam}


def optimum(d: Data, p: dict, rtol: float = 1e-13, max_steps: int = 30,
            lam: float = 1e-6, log=None) -> tuple[dict, dict]:
    """(parameters at the optimum, its ``cost_stats`` and the steps taken).

    An accepted step that lowers the cost by at most ``rtol`` of it while
    the damping is small (λ ≤ 1e-4, a Gauss-Newton step in all but name)
    ends the search; so does ``max_steps``.  ``log``, if given, gets one
    line a step."""
    blocks = _point_blocks(d)
    cost = cost_stats(d, p)["cost"]
    steps = 0
    for _ in range(max_steps):
        ne = _normal_equations(d, p)
        while lam < 1e12:
            step = _step(d, ne, blocks, lam)
            if step is not None:
                cand = _apply(p, *step)
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
