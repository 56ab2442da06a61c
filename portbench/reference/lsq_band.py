"""The plain float64 reference of ``lsq.py`` for problems whose camera
system is a block band: the same functions with the same meaning
(``Data.of``, ``params_on``, ``cost_stats``, ``gauss_newton_gain``,
``optimum``), the reduced camera system kept as a block band.

``lsq.py`` forms the reduced camera system as a dense (6P, 6P) matrix,
28.8 GB in float64 at 10,001 poses.  Here it is held as its upper block
band: ``band[p, d]`` is the 6×6 block that couples pose p with pose
p + d, for d up to the half-width h.  The half-width is read from the
data: a point's observations touch the poses from its first pose_a to
its last pose_b (``lsq._point_blocks``), so its share couples poses at
most span − 1 apart; an observation's own pose_a and pose_b lie in that
run.  The Jacobian pass runs in blocks of ``OBS_BLOCK`` observations, as
in ``lsq.py``, and the Schur complement in blocks of ``POINT_BLOCK``
points.

The band is factored by a plain block-band Cholesky: runs of s = h
consecutive poses form super-blocks of 6s, the band is then block
tridiagonal in them, and L's diagonal and sub-diagonal super-blocks come
one after the other (a dense Cholesky, a triangular solve and a product
each), then two sweeps solve with L and Lᵀ.  Nothing of size (6P)² is
formed.  On problems small enough for ``lsq.py`` the gain, cost and step
equal its own to float64 round-off.

Matmuls run in float64 with TF32 off.
"""
from __future__ import annotations

import torch

from .lsq import (OBS_BLOCK, POINT_BLOCK, Data, _apply, _jacobians,  # noqa: F401
                  _point_blocks, _rho, cost_stats, params_on)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def half_width(d: Data, blocks) -> int:
    """h: the farthest apart two poses that one point couples are."""
    _, slot = blocks
    return int(slot.max()) if slot.numel() else 0


def _normal_equations(d: Data, p: dict, h: int):
    """band (P + h + 1, h + 1, 6, 6), the camera block of JᵀWJ by upper
    blocks (rows past P stay zero), g_c (6P,), C (M, 3, 3), g_x (M, 3),
    E (N, 12, 3) and the camera rows (N, 12) of each observation, with
    constant poses' columns zeroed; the IRLS weights are ρ'(‖r‖²)."""
    P, M, N = d.n_poses, d.n_points, d.n_obs
    dev = d.uv.device
    f64 = dict(dtype=torch.float64, device=dev)
    band = torch.zeros((P + h + 1, h + 1, 6, 6), **f64)
    g_c = torch.zeros(6 * P, **f64)
    C = torch.zeros((M, 3, 3), **f64)
    g_x = torch.zeros((M, 3), **f64)
    E = torch.empty((N, 12, 3), **f64)
    k = torch.arange(6, device=dev)
    ib = d.ib if d.model["rolling_shutter"] else d.ia
    rows = torch.cat([6 * d.ia[:, None] + k, 6 * ib[:, None] + k], dim=1)
    flat = band.view(-1, 6, 6)
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
        H = torch.einsum("nki,nkj->nij", wJc, Jc)
        pose = (d.ia[lo:hi], ib[lo:hi])
        # Block (u, v) of the observation's 12×12 goes to band[pu, pv − pu]
        # where pu ≤ pv; the others are the transposes of those.
        for u in range(2):
            for v in range(2):
                dd = pose[v] - pose[u]
                keep = dd >= 0
                flat.index_add_(0, (pose[u] * (h + 1) + dd)[keep],
                                H[keep][:, 6 * u:6 * u + 6, 6 * v:6 * v + 6])
        g_c.index_add_(0, rows[lo:hi].reshape(-1),
                       torch.einsum("nki,nk->ni", Jc, wr).reshape(-1))
        ip = d.ip[lo:hi]
        C.index_add_(0, ip, torch.einsum("nki,nkj->nij",
                                         w[:, None, None] * Jx, Jx))
        g_x.index_add_(0, ip, torch.einsum("nki,nk->ni", Jx, wr))
        E[lo:hi] = torch.einsum("nki,nkj->nij", wJc, Jx)
    return band, g_c, C, g_x, E, rows


def _band_cholesky(band: torch.Tensor, P: int, h: int):
    """L of the symmetric block band (its upper blocks ``band[:P]``), as
    block-tridiagonal super-blocks of s = max(h, 1) poses: (the n diagonal
    super-blocks of L, its n − 1 sub-diagonal ones), each (6s, 6s), or
    None where the band is not positive definite.  Poses past P are
    padded with the identity."""
    s = max(h, 1)
    n = -(-P // s)
    dev = band.device
    up = torch.zeros((n * s, s + 1 + s, 6, 6), dtype=band.dtype, device=dev)
    up[:P, :h + 1] = band[:P]
    up[P:, 0] = torch.eye(6, dtype=band.dtype, device=dev)
    # T[k, i, j] = block (ks + i, ks + j) for j < 2s, from band[ks + i, j − i].
    i = torch.arange(s, device=dev)[:, None]
    j = torch.arange(2 * s, device=dev)[None, :]
    dd = j - i
    ok = (dd >= 0) & (dd <= h)
    T = up.view(n, s, 2 * s + 1, 6, 6)[:, i, dd.clamp(0, 2 * s)]
    T = T * ok.to(T.dtype)[None, :, :, None, None]
    T = T.permute(0, 1, 3, 2, 4).reshape(n, 6 * s, 2, 6 * s)
    Du, U = T[:, :, 0], T[:, :, 1]                    # (n, 6s, 6s) each
    diag = torch.block_diag(*[torch.ones(6, 6, dtype=T.dtype, device=dev)]
                            * s).bool()
    D = Du + Du.transpose(1, 2) * ~diag               # upper + strict lower
    Ld, Ls, infos = [], [], []
    for k in range(n):
        A = D[k]
        if k:
            X = torch.linalg.solve_triangular(Ld[-1], U[k - 1],
                                              upper=False).transpose(0, 1)
            Ls.append(X)
            A = A - X @ X.transpose(0, 1)
        Lk, info = torch.linalg.cholesky_ex(A)
        Ld.append(Lk)
        infos.append(info)
    if int(torch.stack(infos).abs().sum()) != 0:
        return None
    return Ld, Ls


def _band_solve(factor, rhs: torch.Tensor) -> torch.Tensor:
    """x of L Lᵀ x = rhs (6P,) for ``_band_cholesky``'s factor."""
    Ld, Ls = factor
    n, m = len(Ld), Ld[0].shape[0]
    b = torch.zeros(n * m, dtype=rhs.dtype, device=rhs.device)
    b[:rhs.shape[0]] = rhs
    b = b.view(n, m)
    y = []
    for k in range(n):
        v = b[k] if k == 0 else b[k] - Ls[k - 1] @ y[-1]
        y.append(torch.linalg.solve_triangular(Ld[k], v[:, None],
                                               upper=False)[:, 0])
    x = [None] * n
    for k in reversed(range(n)):
        v = y[k] if k == n - 1 else y[k] - Ls[k].transpose(0, 1) @ x[k + 1]
        x[k] = torch.linalg.solve_triangular(Ld[k].transpose(0, 1),
                                             v[:, None], upper=True)[:, 0]
    return torch.cat(x)[:rhs.shape[0]]


def _step(d, ne, blocks, lam, h):
    """The damped Gauss-Newton step (dc (P, 6), dx (M, 3)) and the decrease
    the model predicts for it, or None where the reduced system is not
    positive definite (``lsq._step`` on the band)."""
    band, g_c, C, g_x, E, rows = ne
    base, slot = blocks
    P, M = d.n_poses, C.shape[0]
    span = h + 1
    eye3 = torch.eye(3, dtype=C.dtype, device=C.device)
    Cd = C + lam * torch.diag_embed(torch.diagonal(C, dim1=1, dim2=2)) \
        + 1e-12 * eye3
    Ci = torch.linalg.inv(Cd)
    S = band.clone()
    dg = torch.diagonal(S[:P, 0], dim1=1, dim2=2)
    S[:P, 0] += torch.diag_embed(lam * torch.clamp(dg, min=1e-12))
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
    iu, ju = torch.triu_indices(span, span, device=E.device)
    flat = S.view(-1, 6, 6)
    for lo in range(0, M, POINT_BLOCK):
        e = El[lo:lo + POINT_BLOCK].reshape(-1, 6 * span, 3)
        K = torch.einsum("mia,mab,mjb->mij", e, Ci[lo:lo + POINT_BLOCK], e)
        Kb = K.view(-1, span, 6, span, 6)[:, iu, :, ju]   # (npairs, m, 6, 6)
        at = (base[lo:lo + POINT_BLOCK, None] + iu) * span + (ju - iu)
        flat.index_add_(0, at.reshape(-1),
                        -Kb.transpose(0, 1).reshape(-1, 6, 6))
    # Constant poses: their rows and columns zeroed, the identity on the
    # diagonal (rows past P count as constant).
    m = torch.zeros(P + span, dtype=S.dtype, device=S.device)
    m[:P] = d.pose_free
    pose = torch.arange(P + span, device=S.device)
    mm = m[:, None] * m[(pose[:, None] + torch.arange(span, device=S.device)
                         ).clamp(max=P + span - 1)]
    S = S[:P + span] * mm[:, :, None, None]
    S[:P, 0] += torch.diag_embed((1.0 - m[:P, None]).expand(P, 6))
    rhs = rhs * torch.repeat_interleave(m[:P], 6)
    factor = _band_cholesky(S, P, h)
    if factor is None:
        return None
    dc = _band_solve(factor, rhs)
    back = torch.zeros((M, 3), dtype=S.dtype, device=S.device)
    back.index_add_(0, d.ip, torch.einsum("nia,ni->na", E, dc[rows]))
    dx = -torch.einsum("mij,mj->mi", Ci, g_x + back)
    return dc.reshape(-1, 6), dx


def gauss_newton_gain(d: Data, p: dict, lam: float = 1e-9) -> dict:
    """What a float64 Gauss-Newton step from ``p`` could still gain
    (``lsq.gauss_newton_gain``): the decrease its model predicts,
    ½ gᵀ H⁻¹ g, zero at a stationary point."""
    blocks = _point_blocks(d)
    h = half_width(d, blocks)
    ne = _normal_equations(d, p, h)
    while (step := _step(d, ne, blocks, lam, h)) is None:
        lam *= 10.0
    dc, dx = step
    _, g_c, _, g_x, _, _ = ne
    return {"gain": -0.5 * float(torch.dot(g_c, dc.reshape(-1))
                                 + torch.sum(g_x * dx)),
            "lambda": lam}


def optimum(d: Data, p: dict, rtol: float = 1e-13, max_steps: int = 30,
            lam: float = 1e-6, log=None) -> tuple[dict, dict]:
    """(parameters at the optimum, its ``cost_stats`` and the steps taken),
    with the stopping rules of ``lsq.optimum``."""
    blocks = _point_blocks(d)
    h = half_width(d, blocks)
    cost = cost_stats(d, p)["cost"]
    steps = 0
    for _ in range(max_steps):
        ne = _normal_equations(d, p, h)
        while lam < 1e12:
            step = _step(d, ne, blocks, lam, h)
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

