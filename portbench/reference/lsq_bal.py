"""The plain float64 reference of a BAL-style problem (``generator_bal``):
residuals with per-camera intrinsics, Jacobians over pose, [f, k1, k2]
and point, one Gauss-Newton step, the robust cost, reprojection
statistics, and the optimum.

It follows ``lsq.py`` and defines ``gn_gain`` (``gauss_newton_gain``),
the cost and the inlier RMSE (``cost_stats``) as it does.  It departs
from it where the problem does:

* global shutter: one pose an observation, no row time, so 6 pose
  columns an observation in place of 12;
* every camera's intrinsics are parameters: ``params["intr"]`` (K, 9),
  stepped through the BAL basis (one focal driving fx and fy, k1, k2),
  so the camera tangent is [poses (6P) | intrinsics (3K)], Dc = 6P + 3K,
  and an observation's camera rows are its pose's 6 and its camera's 3;
* the reduced camera system is dense (Dc × Dc), and each point's share
  E_j C_j⁻¹ E_jᵀ is formed over the rows of the cameras that see it,
  listed per point (a BAL point's cameras need not be consecutive, so
  ``lsq.py``'s run of consecutive poses does not apply), in blocks of
  points so that it fits.

Plain ``torch`` only: it imports no kernel of the program, nothing of
``rsba_tpu_torch`` and no JAX.  Matrix products in TF32 are turned off
for the process (they would touch only float32 products; the
reference's own are float64).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.func import jacfwd, vmap

from . import geometry as geo
from .lsq import OBS_BLOCK, _rho, inlier_threshold

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: points per block of the reduced camera system
POINT_BLOCK = 4096
#: camera rows of one observation: its pose's 6 and its intrinsics' 3
CAM = 9


@dataclasses.dataclass
class Data:
    uv: torch.Tensor
    ia: torch.Tensor       # int64, the pose of each observation
    ii: torch.Tensor       # int64, its intrinsics block
    ip: torch.Tensor       # int64, its point
    pose_free: torch.Tensor
    n_poses: int
    n_intr: int
    n_points: int
    model: dict
    loss: dict

    @staticmethod
    def of(scene, device, dtype=torch.float64) -> "Data":
        """The valid observations of a ``generator_bal.Scene``; the pixels
        in ``dtype``, the model's arithmetic then in the parameters'."""
        m = scene.mask > 0
        i = lambda a: torch.as_tensor(np.asarray(a)[m], dtype=torch.int64,  # noqa: E731
                                      device=device)
        return Data(uv=torch.as_tensor(scene.uv[m], dtype=dtype,
                                       device=device),
                    ia=i(scene.pose_a), ii=i(scene.intr_idx),
                    ip=i(scene.point),
                    pose_free=torch.as_tensor(scene.pose_free,
                                              dtype=torch.float64,
                                              device=device),
                    n_poses=scene.n_poses, n_intr=scene.intr.shape[0],
                    n_points=scene.n_points, model=scene.model,
                    loss=scene.loss)

    @property
    def n_obs(self) -> int:
        return self.uv.shape[0]

    @property
    def cam_dim(self) -> int:
        return 6 * self.n_poses + 3 * self.n_intr


def params_on(params: dict, device, dtype=torch.float64) -> dict:
    """q, c, intr, points (arrays or tensors) as ``dtype`` tensors on
    ``device``."""
    return {k: torch.as_tensor(params[k]).to(device=device, dtype=dtype)
            for k in ("q", "c", "intr", "points")}


def intr_step(intr: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Intrinsics (…, 9) moved by the BAL tangent d (…, 3) = [f, k1, k2]:
    fx and fy by f, k1, k2."""
    z = torch.zeros_like(d[..., :1])
    return intr + torch.cat([d[..., :1], d[..., :1], z, z, d[..., 1:3],
                             z, z, z], dim=-1)


def _project(d: Data, q, c, intr, X) -> torch.Tensor:
    t = torch.zeros(X.shape[:-1], dtype=X.dtype, device=X.device)
    return geo.project(q, c, q, c, intr, X, t, d.model)


def residuals(d: Data, p: dict) -> torch.Tensor:
    """Residuals (n, 2), computed in the parameters' dtype, in float64."""
    return (_project(d, p["q"][d.ia], p["c"][d.ia], p["intr"][d.ii],
                     p["points"][d.ip]) - d.uv).double()


def cost_stats(d: Data, p: dict) -> dict:
    """cost, rmse and inlier rmse (px) at ``p``, and the largest ‖r‖
    (``lsq.cost_stats``'s definitions)."""
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
    """Residuals (n, 2) and Jacobians (n, 2, 12) of observations [lo, hi)
    in the tangent [dθ, dc, df, dk1, dk2, dX]."""
    ia, ii, ip = d.ia[lo:hi], d.ii[lo:hi], d.ip[lo:hi]

    def r(xi, q, c, k, X, uv):
        return _project(d, geo.boxplus(q, xi[0:3]), c + xi[3:6],
                        intr_step(k, xi[6:9]), X + xi[9:12]) - uv

    args = (p["q"][ia], p["c"][ia], p["intr"][ii], p["points"][ip],
            d.uv[lo:hi])
    zero = torch.zeros((hi - lo, 12), dtype=p["q"].dtype,
                       device=p["q"].device)
    res = vmap(r)(zero, *args)
    jac = vmap(jacfwd(r))(zero, *args)
    return res.double(), jac.double()


def _camera_rows(d: Data) -> torch.Tensor:
    """(N, 9) rows of each observation's camera in the camera tangent."""
    dev = d.ia.device
    return torch.cat([6 * d.ia[:, None] + torch.arange(6, device=dev),
                      6 * d.n_poses + 3 * d.ii[:, None]
                      + torch.arange(3, device=dev)], dim=1)


def _normal_equations(d: Data, p: dict):
    """B (Dc, Dc), g_c (Dc,), C (M, 3, 3), g_x (M, 3), E (N, 9, 3) and the
    camera rows (N, 9) of each observation, with constant poses' columns
    zeroed; the IRLS weights are ρ'(‖r‖²)."""
    Dc, M, N = d.cam_dim, d.n_points, d.n_obs
    dev = d.uv.device
    B = torch.zeros((Dc, Dc), dtype=torch.float64, device=dev)
    g_c = torch.zeros(Dc, dtype=torch.float64, device=dev)
    C = torch.zeros((M, 3, 3), dtype=torch.float64, device=dev)
    g_x = torch.zeros((M, 3), dtype=torch.float64, device=dev)
    E = torch.empty((N, CAM, 3), dtype=torch.float64, device=dev)
    rows = _camera_rows(d)
    for lo in range(0, N, OBS_BLOCK):
        hi = min(lo + OBS_BLOCK, N)
        r, J = _jacobians(d, p, lo, hi)
        _, w = _rho(d, torch.sum(r * r, dim=-1))
        Jc = J[:, :, :CAM].clone()
        Jc[:, :, :6] *= d.pose_free[d.ia[lo:hi]][:, None, None]
        Jx = J[:, :, CAM:]
        wJc = w[:, None, None] * Jc
        wr = w[:, None] * r
        rw = rows[lo:hi]
        B.index_put_((rw[:, :, None].expand(-1, CAM, CAM),
                      rw[:, None, :].expand(-1, CAM, CAM)),
                     torch.einsum("nki,nkj->nij", wJc, Jc), accumulate=True)
        g_c.index_add_(0, rw.reshape(-1),
                       torch.einsum("nki,nk->ni", Jc, wr).reshape(-1))
        ip = d.ip[lo:hi]
        C.index_add_(0, ip, torch.einsum("nki,nkj->nij",
                                         w[:, None, None] * Jx, Jx))
        g_x.index_add_(0, ip, torch.einsum("nki,nk->ni", Jx, wr))
        E[lo:hi] = torch.einsum("nki,nkj->nij", wJc, Jx)
    return B, g_c, C, g_x, E, rows


def _point_slots(d: Data):
    """Each observation's slot in its point's list of observations (N,),
    and the longest list."""
    order = torch.argsort(d.ip, stable=True)
    counts = torch.bincount(d.ip, minlength=d.n_points)
    first = torch.cumsum(counts, 0) - counts
    slot = torch.empty_like(d.ip)
    slot[order] = torch.arange(d.n_obs, device=d.ip.device) \
        - first[d.ip[order]]
    return slot, max(int(counts.max()) if d.n_obs else 1, 1)


def _step(d: Data, ne, slots, lam: float):
    """The damped Gauss-Newton step (dc (Dc,), dx (M, 3)), or None where
    the reduced system is not positive definite."""
    B, g_c, C, g_x, E, rows = ne
    slot, L = slots
    Dc, M = B.shape[0], C.shape[0]
    eye3 = torch.eye(3, dtype=C.dtype, device=C.device)
    Cd = C + lam * torch.diag_embed(torch.diagonal(C, dim1=1, dim2=2)) \
        + 1e-12 * eye3
    Ci = torch.linalg.inv(Cd)
    S = B + lam * torch.diag(torch.clamp(torch.diagonal(B), min=1e-12))
    Cg = torch.einsum("mij,mj->mi", Ci, g_x)
    rhs = (-g_c).index_add(
        0, rows.reshape(-1),
        torch.einsum("nia,na->ni", E, Cg[d.ip]).reshape(-1))
    # Each point's E over the camera rows of its observations, in slots;
    # an empty slot holds zeros at row 0.
    El = torch.zeros((M, L, CAM, 3), dtype=E.dtype, device=E.device)
    El[d.ip, slot] = E
    Rl = torch.zeros((M, L, CAM), dtype=rows.dtype, device=rows.device)
    Rl[d.ip, slot] = rows
    for lo in range(0, M, POINT_BLOCK):
        e = El[lo:lo + POINT_BLOCK].reshape(-1, L * CAM, 3)
        K = torch.einsum("mia,mab,mjb->mij", e, Ci[lo:lo + POINT_BLOCK], e)
        r_ = Rl[lo:lo + POINT_BLOCK].reshape(-1, L * CAM)
        S.index_put_((r_[:, :, None].expand_as(K),
                      r_[:, None, :].expand_as(K)), -K, accumulate=True)
    m = torch.cat([torch.repeat_interleave(d.pose_free, 6),
                   torch.ones(3 * d.n_intr, dtype=S.dtype,
                              device=S.device)])
    S = S * m[:, None] * m[None, :] + torch.diag(1.0 - m)
    rhs = rhs * m
    L_, info = torch.linalg.cholesky_ex(S)
    if int(info) != 0:
        return None
    dc = torch.cholesky_solve(rhs[:, None], L_)[:, 0]
    back = torch.zeros((M, 3), dtype=S.dtype, device=S.device)
    back.index_add_(0, d.ip, torch.einsum("nia,ni->na", E, dc[rows]))
    dx = -torch.einsum("mij,mj->mi", Ci, g_x + back)
    return dc, dx


def _apply(d: Data, p: dict, dc, dx) -> dict:
    """The step applied in float64, the result in the parameters' dtype."""
    dt = p["q"].dtype
    q, c, k, x = (p[f].double() for f in ("q", "c", "intr", "points"))
    pose = dc[:6 * d.n_poses].reshape(-1, 6)
    return {"q": geo.boxplus(q, pose[:, :3]).to(dt),
            "c": (c + pose[:, 3:]).to(dt),
            "intr": intr_step(k, dc[6 * d.n_poses:].reshape(-1, 3)).to(dt),
            "points": (x + dx).to(dt)}


def gauss_newton_gain(d: Data, p: dict, lam: float = 1e-9) -> dict:
    """What a float64 Gauss-Newton step from ``p`` could still gain: the
    decrease its model predicts, ½ gᵀ H⁻¹ g (H damped by ``lam`` of its
    diagonal, raised tenfold where the factorisation fails), zero at a
    stationary point (``lsq.gauss_newton_gain``'s definition)."""
    ne = _normal_equations(d, p)
    slots = _point_slots(d)
    while (step := _step(d, ne, slots, lam)) is None:
        lam *= 10.0
    dc, dx = step
    _, g_c, _, g_x, _, _ = ne
    return {"gain": -0.5 * float(torch.dot(g_c, dc) + torch.sum(g_x * dx)),
            "lambda": lam}


def optimum(d: Data, p: dict, rtol: float = 1e-13, max_steps: int = 30,
            lam: float = 1e-6, log=None) -> tuple[dict, dict]:
    """(parameters at the optimum, its ``cost_stats`` and the steps taken),
    by ``lsq.optimum``'s Levenberg-Marquardt rules: an accepted step that
    lowers the cost by at most ``rtol`` of it while λ ≤ 1e-4 ends the
    search, and so does ``max_steps``."""
    slots = _point_slots(d)
    cost = cost_stats(d, p)["cost"]
    steps = 0
    for _ in range(max_steps):
        ne = _normal_equations(d, p)
        while lam < 1e12:
            step = _step(d, ne, slots, lam)
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
