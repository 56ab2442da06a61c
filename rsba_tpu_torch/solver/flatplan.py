"""Host-built observation groupings for the flat solvers.

Counterpart of the groupings in ``rsba_tpu/solver/flatplan.py``.  The
flat engines reduce per-observation blocks by an integer key (pose,
intrinsics block, point, or a pair of them).  The key never changes
during a solve, so the observation axis is sorted by it once on the host
and each key's run is padded into fixed-width rows.  A segmented sum is
then a gather, a dense sum over the slot axis and, where a busy key was
split over several rows, a second gather and sum over its rows: no
atomics, the same order and the same bits every run, and nothing that a
CUDA graph cannot capture.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..problem.types import Problem


class GroupPlan(NamedTuple):
    """Observation axis grouped by one integer key.

    ``slots[r, l]`` indexes the observation axis (``n_obs``: padding,
    which gathers a zero row); ``seg_rows[s, k]`` lists the rows of
    segment ``s`` (``R``: padding), or is None where every segment has
    exactly one row.  ``slots_host`` is the host copy of ``slots``.
    """
    slots: torch.Tensor                # (R, L) int64
    seg_rows: Optional[torch.Tensor]   # (n_segments, K) int64
    n_segments: int
    n_obs: int
    slots_host: np.ndarray

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Segmented sum of (N, ...) by the plan's key → (n_segments, ...)."""
        pad = x.new_zeros((1,) + tuple(x.shape[1:]))
        rows = torch.cat([x, pad])[self.slots].sum(dim=1)
        if self.seg_rows is None:
            return rows
        return torch.cat([rows, pad])[self.seg_rows].sum(dim=1)


def build_group_plan(ids: np.ndarray, n_segments: int, device,
                     max_slot: int = 512) -> GroupPlan:
    """Group the observation axis by ``ids`` (host numpy, O(N log N)).

    Rows hold up to ``max_slot`` observations of one key, in observation
    order; a key with more observations gets several rows."""
    ids = np.asarray(ids).astype(np.int64)
    N = int(ids.shape[0])
    order = np.argsort(ids, kind="stable")
    counts = np.bincount(ids, minlength=n_segments)
    L = int(min(max(int(counts.max()) if counts.size else 1, 1), max_slot))
    rows_per = np.maximum(-(-counts // L), 1)       # ≥ 1 row per segment
    R = int(rows_per.sum())
    starts = np.cumsum(counts) - counts
    row_start = np.cumsum(rows_per) - rows_per
    ids_sorted = ids[order]
    within = np.arange(N) - starts[ids_sorted]
    slots = np.full((R, L), N, np.int64)
    slots[row_start[ids_sorted] + within // L, within % L] = order
    seg_rows = None
    if R != n_segments:
        K = int(rows_per.max())
        table = row_start[:, None] + np.arange(K)[None, :]
        table = np.where(np.arange(K)[None, :] < rows_per[:, None], table, R)
        seg_rows = torch.as_tensor(table, device=device)
    return GroupPlan(slots=torch.as_tensor(slots, device=device),
                     seg_rows=seg_rows, n_segments=int(n_segments), n_obs=N,
                     slots_host=slots)


class PairPlan(NamedTuple):
    """Observations grouped by a pair of keys (i, k): ``group`` reduces to
    one block per unique pair, ``pos_i`` / ``pos_k`` give each unique
    pair's keys, so the reduced blocks land at unique places."""
    group: GroupPlan
    pos_i: torch.Tensor          # (U,) int64
    pos_k: torch.Tensor          # (U,) int64


def build_pair_plan(ids_i: np.ndarray, ids_k: np.ndarray, n_k: int,
                    device) -> PairPlan:
    pair = np.asarray(ids_i).astype(np.int64) * n_k + np.asarray(ids_k)
    upairs, pair_idx = np.unique(pair, return_inverse=True)
    return PairPlan(
        group=build_group_plan(pair_idx.reshape(-1), len(upairs), device),
        pos_i=torch.as_tensor(upairs // n_k, device=device),
        pos_k=torch.as_tensor(upairs % n_k, device=device))


class FlatPlans(NamedTuple):
    """All groupings the flat engines need, built once per solver."""
    pose_a: GroupPlan
    pose_b: Optional[GroupPlan]       # rolling shutter only
    intr: Optional[GroupPlan]         # ni > 0 only
    point: GroupPlan
    #: cross-pair plans for B, (pose_a, pose_b), (pose_a, intr) and
    #: (pose_b, intr), and for E, (point, pose_a), (point, pose_b) and
    #: (point, intr); None where the pair does not exist
    ab: Optional[PairPlan]
    ai: Optional[PairPlan]
    bi: Optional[PairPlan]
    pt_a: Optional[PairPlan]
    pt_b: Optional[PairPlan]
    pt_i: Optional[PairPlan]


def build_flat_plans(problem: Problem, pairs: bool = True) -> FlatPlans:
    """Host-side plan construction (one read of the index arrays).
    ``pairs=False`` leaves out the pair plans, which only the assembly of
    the dense B and E needs."""
    obs = problem.obs
    host = lambda a: a.detach().cpu().numpy().astype(np.int64)  # noqa: E731
    pa, pb, ii, pt = (host(a) for a in (obs.pose_a, obs.pose_b,
                                        obs.intr_idx, obs.point))
    P = int(problem.pose_free.shape[0])
    K = int(problem.intr_free.shape[0])
    M = int(problem.point_free.shape[0])
    rs = problem.model.rolling_shutter
    has_intr = problem.intr_tangent_dim > 0
    dev = problem.device

    def pair(i, k, n_k, wanted=True):
        return build_pair_plan(i, k, n_k, dev) if pairs and wanted else None

    return FlatPlans(
        pose_a=build_group_plan(pa, P, dev),
        pose_b=build_group_plan(pb, P, dev) if rs else None,
        intr=build_group_plan(ii, K, dev) if has_intr else None,
        point=build_group_plan(pt, M, dev),
        ab=pair(pa, pb, P, rs), ai=pair(pa, ii, K, has_intr),
        bi=pair(pb, ii, K, rs and has_intr), pt_a=pair(pt, pa, P),
        pt_b=pair(pt, pb, P, rs), pt_i=pair(pt, ii, K, has_intr))
