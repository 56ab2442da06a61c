"""Window (track-major) observation layout.

Counterpart of ``rsba_tpu/solver/window.py``.  A problem whose feature
tracks span bounded pose windows is re-packed into a ``(row, point,
slot)`` grid:

* each point's observations sit in one row of an ``(NR, G, L)`` grid —
  ``NR`` window rows, ``G`` points per row (padded), ``L`` slots per
  point (padded track length);
* every point in a row shares the W-pose window base ``row_base[r]``;
  heavily populated bases are split across rows.

Per-slot pose data is a gather over the row's W-window, and camera-side
reductions sum per-row windows and fold them into per-pose rows through a
static table of each pose's contributors: a gather and a sum in a fixed
order, so two runs on the same data give the same bits.  The few poses
with far more contributors than the rest (pose 0 collects every row of
the points without observations, whose window base is 0) keep their
surplus in a second table, so that the first stays as narrow as the
common poses need.

Applicability: every point's observations touch a pose window of bounded
span, pose_b ∈ {pose_a, pose_a + 1}, and a single fixed intrinsics
block.  ``build_window_plan`` returns None otherwise.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..problem.types import Problem
from ..utils import trace

#: widest pose window the kernel takes, and build_window_plan's default
MAX_WINDOW = 24
#: the points per row, and by default the row count, are padded to
#: multiples of this
PAD_MULTIPLE = 8


@dataclasses.dataclass
class WindowPlan:
    """Static re-packing of a Problem into the (NR, G, L) window grid.

    Padding: slots with mask == 0; padded point cells have point_id == M
    (the sentinel row appended to gathered point arrays).
    """
    NR: int
    G: int
    L: int
    W: int
    n_poses: int
    n_points: int
    row_base: torch.Tensor    # (NR,) int64 first pose of the row's window
    uv: torch.Tensor          # (NR, G, L, 2)
    t: torch.Tensor           # (NR, G, L)
    mask: torch.Tensor        # (NR, G, L) 1.0 valid / 0.0 padding
    offs_a: torch.Tensor      # (NR, G, L) int64 pose_a − row_base ∈ [0, W)
    rs_ab: torch.Tensor       # (NR, G, L) 1.0 where pose_b == pose_a + 1
    point_id: torch.Tensor    # (NR, G) int64 original point index (M: pad)
    #: (P, K) int64 flat (row·W + w) window cells that fold into each pose,
    #: in increasing order, padded with NR·W (a zero cell): the first K of
    #: each pose's cells
    fold_idx: Optional[torch.Tensor] = None
    #: (H,) int64 the poses with more than K cells, and (H, K') their
    #: further cells, padded alike
    heavy_pose: Optional[torch.Tensor] = None
    heavy_idx: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.fold_idx is None:
            tables = _fold_tables(self.row_base.detach().cpu().numpy(),
                                  self.W, self.n_poses)
            self.fold_idx, self.heavy_pose, self.heavy_idx = (
                torch.as_tensor(t, device=self.row_base.device)
                for t in tables)

    @property
    def n_slots(self) -> int:
        return self.NR * self.G * self.L

    @property
    def offs_b(self) -> torch.Tensor:
        return self.offs_a + self.rs_ab.to(torch.int64)

    def _win_idx(self) -> torch.Tensor:
        return (self.row_base[:, None]
                + torch.arange(self.W, device=self.row_base.device))

    def pose_windows(self, arr: torch.Tensor) -> torch.Tensor:
        """(P, ...) per-pose array → (NR, W, ...): win[r, w] =
        arr[row_base[r] + w], zero past the last pose."""
        pad = arr.new_zeros((self.W,) + tuple(arr.shape[1:]))
        return torch.cat([arr, pad], dim=0)[self._win_idx()]

    def fold(self, v: torch.Tensor) -> torch.Tensor:
        """Adjoint of pose_windows: (NR, W, ...) → (P, ...),
        out[row_base[r] + w] += v[r, w].  Each pose gathers its
        contributing window cells and sums them in the table's order (no
        atomics, no host read: the same bits every run, and it can be
        captured in a CUDA graph); a heavy pose adds the sum of its
        further cells to that of its first K."""
        rest = tuple(v.shape[2:])
        cells = torch.cat([v.reshape((-1,) + rest), v.new_zeros((1,) + rest)])
        out = cells[self.fold_idx].sum(dim=1)
        if self.heavy_pose.numel():
            hp = self.heavy_pose
            out = out.index_put((hp,), out[hp]
                                + cells[self.heavy_idx].sum(dim=1))
        return out

    def _select(self, win: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
        rows = torch.arange(self.NR, device=offs.device)[:, None, None]
        return win[rows, offs]

    def select_a(self, win: torch.Tensor) -> torch.Tensor:
        """Per-slot pose_a values: (NR, W, ...) → (NR, G, L, ...)."""
        return self._select(win, self.offs_a)

    def select_b(self, win: torch.Tensor) -> torch.Tensor:
        """Per-slot pose_b values (pose_a + rs_ab)."""
        return self._select(win, self.offs_b)

    def gather_points(self, points: torch.Tensor) -> torch.Tensor:
        """(M, D) → (NR, G, D) padded window layout (sentinel row zero)."""
        ext = torch.cat([points, points.new_zeros((1, points.shape[1]))])
        return ext[self.point_id]

    def scatter_points(self, pts_w: torch.Tensor) -> torch.Tensor:
        """(NR, G, D) window layout → (M, D) original order.  Every point
        occupies exactly one cell, so this is an index put; padded cells
        write into a dropped sentinel row."""
        D = pts_w.shape[-1]
        out = pts_w.new_zeros((self.n_points + 1, D))
        out[self.point_id.reshape(-1)] = pts_w.reshape(-1, D)
        return out[:self.n_points]

    def gather_point_scalar(self, v: torch.Tensor) -> torch.Tensor:
        """(M,) → (NR, G) via the point permutation (sentinel 0)."""
        return torch.cat([v, v.new_zeros((1,))])[self.point_id]

    def rows(self, r0: int, r1: int) -> "WindowPlan":
        """The plan of rows [r0, r1), in memory of its own: ``NR = r1 −
        r0``, the same poses and points (``point_id`` keeps global point
        indices), and a fold table built from its own ``row_base``, so
        its folds are partial sums over all poses."""
        if not 0 <= r0 <= r1 <= self.NR:
            raise ValueError(f"rows [{r0}, {r1}) of a plan of {self.NR}")
        return WindowPlan(
            NR=r1 - r0, G=self.G, L=self.L, W=self.W, n_poses=self.n_poses,
            n_points=self.n_points,
            **{f: getattr(self, f)[r0:r1].clone() for f in _ROW_FIELDS})

    def to(self, device) -> "WindowPlan":
        """The plan with its tensors on ``device``."""
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device)
                     for f in _ROW_FIELDS + _FOLD_FIELDS})


#: the WindowPlan fields with one entry per row, and the fold's tables
_ROW_FIELDS = ("row_base", "uv", "t", "mask", "offs_a", "rs_ab", "point_id")
_FOLD_FIELDS = ("fold_idx", "heavy_pose", "heavy_idx")


def _fold_tables(row_base: np.ndarray, W: int, n_poses: int):
    """Each pose's flat window cells (row·W + w), in increasing order,
    padded with the sentinel NR·W: (fold_idx, heavy_pose, heavy_idx).
    The first table's width K minimises the cells of both tables together,
    P·K + H·(K_max − K), where H poses have more than K cells."""
    NR = row_base.shape[0]
    pose = (row_base[:, None] + np.arange(W)[None, :]).reshape(-1)
    cell = np.nonzero(pose < n_poses)[0]
    cell = cell[np.argsort(pose[cell], kind="stable")]
    pose = pose[cell]
    counts = np.bincount(pose, minlength=n_poses)
    k_max = max(int(counts.max()), 1)
    ks = np.unique(np.maximum(counts, 1))
    padded = [n_poses * w + (counts > w).sum() * (k_max - w) for w in ks]
    k = int(ks[np.argmin(padded)])
    heavy = np.nonzero(counts > k)[0]
    pos = np.arange(pose.size) - (np.cumsum(counts) - counts)[pose]
    table = np.full((n_poses, k), NR * W, np.int64)
    first = pos < k
    table[pose[first], pos[first]] = cell[first]
    extra = np.full((heavy.size, k_max - k), NR * W, np.int64)
    row_of = np.searchsorted(heavy, pose[~first])
    extra[row_of, pos[~first] - k] = cell[~first]
    return table, heavy, extra


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def shapes_admit(problem: Problem) -> bool:
    """Whether the window layout may fit ``problem`` by its shapes: one
    intrinsics block, held fixed.  Where this is false no data makes
    ``build_window_plan`` return a plan."""
    return (problem.intr_tangent_dim == 0
            and problem.intr_free.shape[0] == 1)


def build_window_plan(problem: Problem, max_window: int = MAX_WINDOW,
                      nr_multiple: int = PAD_MULTIPLE
                      ) -> Optional[WindowPlan]:
    """The problem's window plan, built where its tensors live.  Returns
    None when the problem does not fit the window layout or a track spans
    more than ``max_window`` poses.  Points per row G is the 95th
    percentile of points per window base, so padding stays bounded under
    skew; the row count is padded to a multiple of ``nr_multiple`` (the
    sharded solver splits it evenly).

    Every step over the observations (the check of pose_b − pose_a, the
    stable sort by point, the per-point counts, window bases and spans,
    the cells' points, the slots' observations and the packs) is a torch
    op on the problem's device.  The host reads back three scalars, the
    points of each window base (``n_poses`` integers), from which it
    picks G and lays out the rows, and the final range check; each read
    adds its bytes to the ``host_bytes`` of the innermost open span."""
    if not shapes_admit(problem):
        return None
    obs = problem.obs
    dev = problem.device
    n_points = int(problem.point_free.shape[0])
    n_poses = int(problem.pose_free.shape[0])
    n_flat = obs.n_obs
    if n_points == 0 or n_flat == 0:
        return None
    i64 = dict(dtype=torch.int64, device=dev)

    # Per-point observation lists (valid obs only), via one stable sort:
    # invalid observations take the key n_points and sort last.
    valid = obs.mask > 0
    pose_a = obs.pose_a.long()
    pose_b = obs.pose_b.long()
    d_ab = pose_b - pose_a
    key = torch.where(valid, obs.point.long(), n_points)
    key_sorted, order = torch.sort(key, stable=True)
    bounds = torch.searchsorted(key_sorted,
                                torch.arange(n_points + 1, **i64))
    offsets = bounds[:-1]
    counts = bounds[1:] - offsets

    # Window base and span per point (over both pose_a and pose_b).
    lo = torch.full((n_points + 1,), np.iinfo(np.int32).max, **i64
                    ).scatter_reduce_(0, key, pose_a, "amin")[:n_points]
    hi = torch.full((n_points + 1,), -1, **i64
                    ).scatter_reduce_(0, key, pose_b, "amax")[:n_points]
    has_obs = counts > 0
    base = torch.where(has_obs, lo, 0)
    span = torch.where(has_obs, hi - lo + 1, 0)
    bad_ab = (valid & (d_ab != 0) & (d_ab != 1)).any()
    bad_ab, L, W = _read(torch.stack([bad_ab.long(), counts.max(),
                                      span.max()])).tolist()
    if bad_ab or L == 0 or W > max_window:
        return None
    del key, key_sorted, bounds, lo, hi, has_obs, span, valid, pose_b

    # Rows: group points by base, splitting heavy bases into chunks of G.
    base_sorted, porder = torch.sort(base, stable=True)
    b_bounds = torch.searchsorted(base_sorted, torch.arange(n_poses + 1,
                                                            **i64))
    b_counts = _read(b_bounds[1:] - b_bounds[:-1])
    del base, base_sorted, b_bounds
    pos_counts = b_counts[b_counts > 0]
    g_target = int(np.percentile(pos_counts, 95))
    G = _round_up(max(min(g_target, int(pos_counts.max())), 1), PAD_MULTIPLE)

    n_chunks = -(-b_counts // G)
    base_start = np.cumsum(b_counts) - b_counts
    NR0 = int(n_chunks.sum())
    row_base0 = np.repeat(np.arange(b_counts.size), n_chunks)
    first_row = np.cumsum(n_chunks) - n_chunks
    row_in_base = np.arange(NR0) - first_row[row_base0]
    row_of_chunk = base_start[row_base0] + row_in_base * G
    row_len = np.minimum(G, b_counts[row_base0] - row_in_base * G)

    # Pad the row count with empty masked rows.
    NR = _round_up(max(NR0, 1), nr_multiple)
    row_base = np.zeros(NR, dtype=np.int64)
    row_base[:NR0] = row_base0

    as_i = lambda a: torch.as_tensor(a, **i64)  # noqa: E731
    cols = torch.arange(G, **i64)
    src = (as_i(row_of_chunk)[:, None] + cols).clamp_(max=n_points - 1)
    point_id = torch.full((NR, G), n_points, **i64)
    point_id[:NR0] = torch.where(cols < as_i(row_len)[:, None],
                                 porder[src], n_points)
    del porder, src

    # Per-slot flat obs index (sentinel = len(obs) → zero row).
    pid = point_id.reshape(-1)
    zero = counts.new_zeros(1)
    slots = torch.arange(L, **i64)
    slot_src = (torch.cat([offsets, zero])[pid][:, None] + slots
                ).clamp_(max=n_flat - 1)
    obs_sel = torch.where(slots < torch.cat([counts, zero])[pid][:, None],
                          order[slot_src], n_flat).reshape(NR, G, L)
    del offsets, counts, order, slot_src

    def pack(a):
        return torch.cat([a, a.new_zeros((1,) + tuple(a.shape[1:]))]
                         )[obs_sel]

    row_base_d = as_i(row_base)
    filled = obs_sel < n_flat
    dab = pack(d_ab)
    offs_a = torch.where(filled, pack(pose_a) - row_base_d[:, None, None],
                         0)
    if _read((offs_a.min() < 0) | ((offs_a + dab).max() >= W)).item():
        return None

    dt = obs.uv.dtype
    fold_idx, heavy_pose, heavy_idx = (
        as_i(t) for t in _fold_tables(row_base, W, n_poses))
    return WindowPlan(
        NR=NR, G=G, L=L, W=W, n_poses=n_poses, n_points=n_points,
        row_base=row_base_d, uv=pack(obs.uv), t=pack(obs.t.to(dt)),
        mask=filled.to(dt), offs_a=offs_a, rs_ab=dab.to(dt),
        point_id=point_id, fold_idx=fold_idx, heavy_pose=heavy_pose,
        heavy_idx=heavy_idx)


def _read(x: torch.Tensor) -> np.ndarray:
    """``x`` as a host array, its bytes counted under ``host_bytes``."""
    trace.add(host_bytes=x.numel() * x.element_size())
    return x.cpu().numpy()
