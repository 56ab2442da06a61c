"""Visibility-clustered block preconditioner for the flat PCG path.

Counterpart of ``rsba_tpu/solver/cluster.py`` (Ceres ``CLUSTER_JACOBI``):
cluster the camera co-visibility graph, keep the reduced camera system S
restricted to the cluster diagonal, factor each cluster block dense, and
apply it as a batched block solve inside PCG.  The banded engine's
``cluster_jacobi`` (contiguous trajectory segments, ``banded.py``) is the
video special case; this module is the general tier for unordered
problems on ``iterative_schur``.

* host, once per solver: greedy size-capped agglomeration over the
  co-visibility edge weights; the same-point observation pairs whose
  cameras share a cluster, grouped by (pose_i, pose_k) with pose_i <
  pose_k;
* device, once per solve step: the cluster blocks
  S_c[p, q] = δ_pq·(B_pp + λ) − Σ_j F_jp C_jλ⁻¹ F_jqᵀ, each unique block
  written once into (n_clusters, D_max, D_max), and one batched Cholesky.

The per-pose diagonal terms are exactly the SCHUR_JACOBI blocks
(``pcg.schur_jacobi_partial``); clustering adds the within-cluster
off-diagonal coupling.  Intrinsics blocks keep their own Schur-Jacobi
treatment (Ceres clusters cameras only).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..problem.types import POSE_DOF, Problem
from . import flatplan


def _host(a: torch.Tensor) -> np.ndarray:
    return a.detach().cpu().numpy().astype(np.int64)


def cluster_cameras(problem: Problem, point_plan: flatplan.GroupPlan,
                    max_size: int = 8) -> np.ndarray:
    """(P,) cluster id per pose: greedy co-visibility agglomeration.

    Edges are weighted by the number of points two cameras co-observe
    (counted over the point grouping's slot pairs) and merged heaviest
    first under a ``max_size`` cap, the usual greedy stand-in for Ceres's
    canonical-views clustering.
    """
    P = int(problem.pose_free.shape[0])
    N = point_plan.n_obs
    pa = _host(problem.obs.pose_a)
    slots = point_plan.slots_host
    cam = np.concatenate([pa, [-1]])[np.minimum(slots, N)]      # (R, L)
    il, ik = np.triu_indices(cam.shape[1], 1)
    ci = cam[:, il].ravel()
    ck = cam[:, ik].ravel()
    ok = (ci >= 0) & (ck >= 0) & (ci != ck)
    lo = np.minimum(ci[ok], ck[ok])
    hi = np.maximum(ci[ok], ck[ok])
    edge_ids, weights = np.unique(lo.astype(np.int64) * P + hi,
                                  return_counts=True)
    order = np.argsort(-weights)
    parent = np.arange(P)
    size = np.ones(P, np.int64)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for e in edge_ids[order]:
        a, b = find(int(e // P)), find(int(e % P))
        if a != b and size[a] + size[b] <= max_size:
            parent[b] = a
            size[a] += size[b]
    roots = np.array([find(i) for i in range(P)])
    _, ids = np.unique(roots, return_inverse=True)
    return ids.reshape(-1)


class ClusterPlan(NamedTuple):
    """Everything the solve-step assembly needs, built once."""
    cluster_of: torch.Tensor     # (P,) int64
    local_of: torch.Tensor       # (P,) int64 pose slot within its cluster
    n_clusters: int
    max_poses: int               # largest cluster (pose count)
    #: same-point observation pairs with co-clustered cameras,
    #: pose of pair_i < pose of pair_k
    pair_i: torch.Tensor         # (NP,) int64 obs index
    pair_k: torch.Tensor         # (NP,) int64 obs index
    pair_point: torch.Tensor     # (NP,) int64
    pairs: flatplan.PairPlan     # grouped by (pose_i, pose_k)
    pose_table: torch.Tensor     # (n_clusters, max_poses) pose id; P = pad
    pad_diag: torch.Tensor       # (n_clusters, D) 1.0 on unused slots' dims


def build_cluster_plan(problem: Problem, point_plan: flatplan.GroupPlan,
                       max_size: int = 8) -> ClusterPlan:
    ids = cluster_cameras(problem, point_plan, max_size)
    P = ids.shape[0]
    n_c = int(ids.max()) + 1 if ids.size else 1
    local = np.zeros(P, np.int64)
    counts = np.zeros(n_c, np.int64)
    for p in range(P):
        local[p] = counts[ids[p]]
        counts[ids[p]] += 1
    max_poses = int(counts.max()) if n_c else 1

    N = point_plan.n_obs
    pa = _host(problem.obs.pose_a)
    pt = _host(problem.obs.point)
    slots = point_plan.slots_host
    il, ik = np.triu_indices(slots.shape[1], 1)
    oi = slots[:, il].ravel()
    ok = slots[:, ik].ravel()
    valid = (oi < N) & (ok < N)
    oi, ok = oi[valid], ok[valid]
    keep = (ids[pa[oi]] == ids[pa[ok]]) & (pa[oi] != pa[ok])
    oi, ok = oi[keep], ok[keep]
    swap = pa[oi] > pa[ok]
    oi, ok = np.where(swap, ok, oi), np.where(swap, oi, ok)
    dev = problem.device
    table = np.full((n_c, max_poses), P, np.int64)
    table[ids, local] = np.arange(P)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.int64,  # noqa: E731
                                     device=dev)
    return ClusterPlan(
        cluster_of=as_t(ids), local_of=as_t(local), n_clusters=n_c,
        max_poses=max_poses, pair_i=as_t(oi), pair_k=as_t(ok),
        pair_point=as_t(pt[oi]),
        pairs=flatplan.build_pair_plan(pa[oi], pa[ok], P, dev),
        pose_table=as_t(table),
        pad_diag=torch.as_tensor(
            np.repeat(table == P, POSE_DOF, axis=1),
            dtype=problem.pose_free.dtype, device=dev))


def cluster_blocks(cp: ClusterPlan, D_pose: torch.Tensor, ev,
                   C_inv: torch.Tensor) -> torch.Tensor:
    """(n_clusters, D, D) dense cluster blocks of S_λ.

    D_pose: the damped per-pose Schur-Jacobi diagonal blocks (P, 6, 6),
    placed on each cluster block's diagonal.  The off-diagonal coupling
    −Σ_j F_jp C_jλ⁻¹ F_jqᵀ comes from the same-point pair list.  Unused
    slots get identity rows, so the batched Cholesky stays PD.
    """
    mp = cp.max_poses
    D = mp * POSE_DOF
    c_of, loc = cp.cluster_of, cp.local_of
    out = D_pose.new_zeros((cp.n_clusters, mp, POSE_DOF, mp, POSE_DOF))
    out[c_of, loc, :, loc, :] = D_pose

    if cp.pair_i.shape[0] > 0:
        f = torch.einsum("nrw,nrp->nwp", ev.J_pose[:, :, 0, :], ev.J_pt)
        cross = cp.pairs.group.reduce(-torch.einsum(
            "nwp,npq,nvq->nwv", f[cp.pair_i], C_inv[cp.pair_point],
            f[cp.pair_k]))                                   # (U, 6, 6)
        pi, pk = cp.pairs.pos_i, cp.pairs.pos_k
        out[c_of[pi], loc[pi], :, loc[pk], :] = cross
        out[c_of[pi], loc[pk], :, loc[pi], :] = cross.transpose(-1, -2)

    return out.reshape(cp.n_clusters, D, D) + torch.diag_embed(cp.pad_diag)


def make_cluster_preconditioner(cp: ClusterPlan, D_pose, D_intr, shapes,
                                ev, problem, C_inv):
    """M⁻¹ apply for PCG: batched cluster-block solves (+ intr blocks)."""
    from .pcg import batched_cho_solve, batched_cholesky
    Lc = batched_cholesky(cluster_blocks(cp, D_pose, ev, C_inv))
    ni = shapes.ni
    L_intr = batched_cholesky(D_intr) if ni > 0 else None
    p6 = shapes.n_poses * POSE_DOF
    D = cp.max_poses * POSE_DOF

    def apply(r: torch.Tensor) -> torch.Tensor:
        rp = r[:p6].reshape(shapes.n_poses, POSE_DOF)
        ext = torch.cat([rp, rp.new_zeros((1, POSE_DOF))])
        zc = batched_cho_solve(
            Lc, ext[cp.pose_table].reshape(cp.n_clusters, D))
        zp = zc.reshape(cp.n_clusters, cp.max_poses, POSE_DOF)[
            cp.cluster_of, cp.local_of].reshape(-1)
        if ni > 0:
            zi = batched_cho_solve(
                L_intr, r[p6:].reshape(shapes.n_intr, ni)).reshape(-1)
            return torch.cat([zp, zi])
        return zp

    return apply
