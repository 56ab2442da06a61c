"""Host-side problem repartitioning for the flat sharded solver.

Counterpart of ``rsba_tpu/dist/partition.py``, the same numpy on the
host.  Layout contract (consumed by ``dist.sharded``):

* Points are permuted into ``n_shards`` contiguous, equal-size chunks of
  ``m_local`` points; shard d owns points ``[d·m_local, (d+1)·m_local)``.
  Points are ordered by the first keyframe of their track, so a shard's
  points are seen by a contiguous window of cameras and landmark
  elimination stays within the shard.
* Observations follow their point's shard, padded per shard to a common
  count ``n_local`` (mask 0; padding rows point at the shard's first
  point, so gathers stay in the shard).
* Poses and intrinsics are whole on every shard; their gradient and
  Hessian contributions are summed over the shards.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..problem.types import Observations, Params, Problem


@dataclasses.dataclass(frozen=True)
class PartitionInfo:
    """Bookkeeping to map between original and shard point order."""
    n_shards: int
    m_local: int           # points per shard (after padding)
    n_local: int           # observation slots per shard (after padding)
    n_points_orig: int
    point_old2new: np.ndarray   # (M_orig,) new index of original point i
    point_new2old: np.ndarray   # (M_pad,)  original index (or -1 for padding)

    def restore_points(self, points: torch.Tensor) -> torch.Tensor:
        """Shard-ordered (M_pad, 3) → original order (M_orig, 3)."""
        return points[torch.as_tensor(self.point_old2new,
                                      device=points.device)]


def repartition_by_point(problem: Problem, params: Params, n_shards: int,
                         obs_pad_align: int = 8,
                         ) -> tuple[Problem, Params, PartitionInfo]:
    """Permute points and observations into the shard-ownership layout;
    the result lives on the problem's device."""
    obs = problem.obs
    host = lambda a: a.detach().cpu().numpy()  # noqa: E731
    uv, t, mask = host(obs.uv), host(obs.t), host(obs.mask)
    pose_a, pose_b = host(obs.pose_a), host(obs.pose_b)
    intr_idx, point = host(obs.intr_idx), host(obs.point)
    valid = mask > 0
    M = params.n_points

    # Locality order: first camera block (pose_a) that observes each point.
    first_pose = np.full(M, np.iinfo(np.int64).max // 2, dtype=np.int64)
    np.minimum.at(first_pose, point[valid], pose_a[valid])
    order = np.argsort(first_pose, kind="stable")       # new → old
    m_local = -(-M // n_shards)
    M_pad = m_local * n_shards

    point_new2old = np.full(M_pad, -1, dtype=np.int64)
    point_new2old[:M] = order
    point_old2new = np.empty(M, dtype=np.int64)
    point_old2new[order] = np.arange(M)

    dev = problem.device

    def pad_pts(a: torch.Tensor) -> torch.Tensor:
        a = host(a)
        out = np.zeros((M_pad,) + a.shape[1:], dtype=a.dtype)
        out[:M] = a[order]
        return torch.as_tensor(out, device=dev)

    params2 = params.replace(points=pad_pts(params.points))
    point_free2 = pad_pts(problem.point_free)

    # Group valid observations by owning shard.
    new_pt = point_old2new[point[valid]]
    shard_of = new_pt // m_local
    counts = np.bincount(shard_of, minlength=n_shards)
    n_local = int(counts.max()) if counts.size else 1
    n_local = max(-(-n_local // obs_pad_align) * obs_pad_align, obs_pad_align)

    idx_valid = np.nonzero(valid)[0]
    N_tot = n_shards * n_local
    uv2 = np.zeros((N_tot, 2), uv.dtype)
    t2 = np.zeros((N_tot,), t.dtype)
    pa2 = np.zeros((N_tot,), np.int32)
    pb2 = np.zeros((N_tot,), np.int32)
    ii2 = np.zeros((N_tot,), np.int32)
    pt2 = np.zeros((N_tot,), np.int32)
    mk2 = np.zeros((N_tot,), mask.dtype)
    for d in range(n_shards):
        sel = idx_valid[shard_of == d]
        k = sel.shape[0]
        base = d * n_local
        uv2[base:base + k] = uv[sel]
        t2[base:base + k] = t[sel]
        pa2[base:base + k] = pose_a[sel]
        pb2[base:base + k] = pose_b[sel]
        ii2[base:base + k] = intr_idx[sel]
        pt2[base:base + k] = point_old2new[point[sel]]
        mk2[base:base + k] = 1.0
        # padding rows gather the shard's first owned point (local index 0)
        pt2[base + k:base + n_local] = d * m_local

    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    obs2 = Observations(uv=T(uv2), t=T(t2), pose_a=T(pa2), pose_b=T(pb2),
                        intr_idx=T(ii2), point=T(pt2), mask=T(mk2))
    problem2 = problem.replace(obs=obs2, point_free=point_free2)
    info = PartitionInfo(
        n_shards=n_shards, m_local=m_local, n_local=n_local,
        n_points_orig=M, point_old2new=point_old2new,
        point_new2old=point_new2old)
    return problem2, params2, info
