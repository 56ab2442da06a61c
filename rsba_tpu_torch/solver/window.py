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
    """Host-side (numpy) plan construction; the plan's tensors live on the
    problem's device.  Returns None when the problem does not fit the
    window layout or a track spans more than ``max_window`` poses.
    Points per row G is the 95th percentile of points per window base, so
    padding stays bounded under skew; the row count is padded to a
    multiple of ``nr_multiple`` (the sharded solver splits it evenly)."""
    if not shapes_admit(problem):
        return None
    obs = problem.obs
    host = lambda a: a.detach().cpu().numpy()  # noqa: E731
    pose_a = host(obs.pose_a).astype(np.int64)
    pose_b = host(obs.pose_b).astype(np.int64)
    point = host(obs.point).astype(np.int64)
    mask = host(obs.mask) > 0
    d_ab = pose_b - pose_a
    if not np.all(np.isin(d_ab[mask], (0, 1))):
        return None

    n_points = int(problem.point_free.shape[0])
    n_poses = int(problem.pose_free.shape[0])

    # Per-point observation lists (valid obs only), via one stable sort.
    valid_idx = np.nonzero(mask)[0]
    order = valid_idx[np.argsort(point[valid_idx], kind="stable")]
    pts_sorted = point[order]
    counts = np.bincount(pts_sorted, minlength=n_points)
    if counts.size == 0 or counts.max() == 0:
        return None
    L = int(counts.max())
    offsets = np.cumsum(counts) - counts

    # Window base and span per point (over both pose_a and pose_b).
    lo = np.full(n_points, np.iinfo(np.int32).max, dtype=np.int64)
    hi = np.full(n_points, -1, dtype=np.int64)
    np.minimum.at(lo, pts_sorted, pose_a[order])
    np.maximum.at(hi, pts_sorted, pose_b[order])
    has_obs = counts > 0
    lo[~has_obs] = 0
    hi[~has_obs] = 0
    W = int((hi - lo + 1)[has_obs].max())
    if W > max_window:
        return None
    base = lo

    # Rows: group points by base, splitting heavy bases into chunks of G.
    porder = np.argsort(base, kind="stable")
    b_counts = np.bincount(base, minlength=int(base.max()) + 1)
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

    cols = np.arange(G)
    cell_valid = cols[None, :] < row_len[:, None]
    src = row_of_chunk[:, None] + cols[None, :]
    point_id = np.full((NR, G), n_points, dtype=np.int64)
    point_id[:NR0][cell_valid] = porder[src[cell_valid]]

    # Per-slot flat obs index (sentinel = len(obs) → zero row).
    n_flat = pose_a.shape[0]
    obs_sel = np.full((NR * G, L), n_flat, dtype=np.int64)
    pid_flat = point_id.reshape(-1)
    rows = np.nonzero(pid_flat < n_points)[0]
    pj = pid_flat[rows]
    slot_valid = np.arange(L)[None, :] < counts[pj][:, None]
    slot_src = offsets[pj][:, None] + np.arange(L)[None, :]
    obs_sel[rows[:, None], np.broadcast_to(np.arange(L), slot_valid.shape)
            ] = np.where(slot_valid,
                         order[np.minimum(slot_src, order.size - 1)], n_flat)
    obs_sel = obs_sel.reshape(NR, G, L)

    def pack(a, fill=0.0):
        ext = np.concatenate(
            [a, np.full((1,) + a.shape[1:], fill, dtype=a.dtype)])
        return ext[obs_sel]

    uv_h = host(obs.uv)
    pa = pack(pose_a, fill=0)
    dab = pack(d_ab, fill=0)
    offs_a = np.where(obs_sel < n_flat, pa - row_base[:, None, None], 0)
    if offs_a.min() < 0 or (offs_a + dab).max() >= W:
        return None

    dev, dt = problem.device, obs.uv.dtype
    as_f = lambda a: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    as_i = lambda a: torch.as_tensor(a, dtype=torch.int64,  # noqa: E731
                                     device=dev)
    return WindowPlan(
        NR=NR, G=G, L=L, W=W, n_poses=n_poses, n_points=n_points,
        row_base=as_i(row_base), uv=as_f(pack(uv_h)),
        t=as_f(pack(host(obs.t))), mask=as_f(pack(mask.astype(uv_h.dtype))),
        offs_a=as_i(offs_a), rs_ab=as_f(dab), point_id=as_i(point_id))
