"""Incremental video-SfM session.

Counterpart of ``rsba_tpu/pipeline/session.py``: the workflow ``new
session → add frame → solve`` as a Python API.  Each incoming frame is
registered against the map (PnP from the previous pose, RANSAC when no
usable prior), newly complete tracks are triangulated, a windowed bundle
adjustment runs, and the growing reconstruction is exposed.

Structure per frame (host-orchestrated; each numbered step is one batched
computation on the device and one read-back):

1. **Bootstrap** (first usable pair): 8-point essential + cheirality
   (geometry.epipolar.two_view_init), unit-baseline gauge, midpoint
   triangulation of the shared tracks.
2. **Register**: pose-only robust LM from the previous frame's pose
   (solver.pnp.register_frame); falls back to batched P3P-RANSAC
   (solver.ransac) when the prior fails or is unavailable.
3. **Triangulate** new tracks with ≥ ``min_views`` registered views
   (geometry.triangulate — interpolated-pose variant under RS), gated on
   conditioning, cheirality, and reprojection error.
4. **Windowed BA** every ``ba_interval`` frames: all frames outside the
   window and the two gauge frames are held constant via the free masks
   (Ceres ``SetParameterBlockConstant`` parity); the solver auto-selects
   the banded window engine, whose prepare is the fused
   evaluate+assemble kernel on a CUDA device.

Rolling shutter: poses are per-frame (row-0) keyframes; frame i's rows
interpolate pose i → pose i+1 (the adjacent-keyframe model of the window
layout).  The newest frame's successor is a **virtual end pose** (zero-
velocity initialized, refined by BA) so the sequence model matches the
synthetic video generator's exactly; it is replaced by the real pose when
the next frame registers.  Frame *registration* under RS runs the full
RS ``register_frame``: the estimated (row-0, row-H) pose pair IS the
session's (frame pose, virtual end pose) — see ``_register``; the
windowed RS BA then refines the whole model jointly.

Ingest is O(new work) per frame: per-frame observation indices,
per-track registered-view counters, a dirty set of triangulation
candidates and an append-only pool of solver-ready observations; no
track is rescanned.

The session's state (poses, tracks, map) lives on the host in float64;
``device`` and ``dtype`` say where and in what precision each step
computes.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .. import default_device
from ..geometry import CameraModel, Loss, epipolar, triangulate
from ..problem.types import (Observations, Params, intr_basis_fixed,
                             make_problem)
from ..solver import lm
from ..solver.options import SolverOptions
from ..solver.pnp import register_frame
from ..solver.ransac import ransac_pnp
from ..utils import trace


class SfmSession:
    """Incremental reconstruction of one video with a shared camera."""

    def __init__(self, intr, model: CameraModel, image_size,
                 *, window: int = 8, ba_interval: int = 1,
                 min_views: int = 2, min_common: int = 16,
                 inlier_threshold: float = 6.0,
                 loss: Loss = Loss("huber", 4.0),
                 options: Optional[SolverOptions] = None,
                 dtype=torch.float64, seed: int = 0,
                 shape_buckets: bool = False, device=None,
                 register_options: Optional[SolverOptions] = None):
        """``device=None`` is the card (RuntimeError without one); pass
        ``device="cpu"`` for the CPU.  ``options`` are the bundle
        adjustments'; ``register_options`` (not in the reference, whose
        registrations always take ``register_frame``'s defaults) are
        passed to ``register_frame`` and to the polish of ``ransac_pnp``,
        None meaning their defaults."""
        self.device = default_device(device)
        self.intr = np.array(intr, np.float64)
        self.model = model
        self.image_size = tuple(image_size)
        self.window = window
        self.ba_interval = ba_interval
        self.min_views = min_views
        self.min_common = min_common
        self.inlier_threshold = inlier_threshold
        self.loss = loss
        self.options = options or SolverOptions(
            linear_solver="auto", max_iterations=40)
        self.register_options = register_options
        self.dtype = dtype
        self.seed = seed
        # Bucket BA problem shapes (poses → ×8, points → ×256,
        # observations → ×2048), so that a growing session meets few
        # distinct problem shapes.
        self.shape_buckets = shape_buckets

        self.q: List[np.ndarray] = []        # per-frame row-0 poses
        self.c: List[np.ndarray] = []
        # RS: the end pose of the newest frame (row H), refined by BA.
        self.q_virtual: Optional[np.ndarray] = None
        self.c_virtual: Optional[np.ndarray] = None
        self.registered: List[bool] = []
        #: tid -> {"frames": [...], "uv": [(2,)...], "rows": [...],
        #:         "n_reg": int (registered views), "pooled": set of obs
        #:         indices already in the solver pool}
        self.tracks: Dict[int, dict] = {}
        self.points: Dict[int, np.ndarray] = {}   # triangulated map
        self.bootstrapped = False
        self.log: List[dict] = []
        #: one record per bundle adjustment: frames, window, the resolved
        #: engine, termination, iterations, wall
        self.ba_log: List[dict] = []
        #: registrations that went through the prior, and through RANSAC
        self.n_registered_by = {"pnp_prior": 0, "ransac": 0}
        # --- incremental indices (O(new work) per frame) -----------------
        #: frame -> [(tid, obs_index_in_track), ...]
        self._frame_obs: List[list] = []
        #: untriangulated tracks whose registered-view count changed
        self._dirty: set = set()
        #: frames whose observations entered the solver pool (frame AND
        #: its RS successor registered — stable forever after)
        self._pooled_frames: List[bool] = []
        #: append-only solver-ready observation pool (parallel lists)
        self._pool = {"tid": [], "pa": [], "pb": [], "uv": [], "t": []}

    # --- public API -----------------------------------------------------

    @property
    def n_frames(self) -> int:
        return len(self.q)

    def add_frame(self, track_ids, uv, rows=None) -> dict:
        """Ingest one frame's feature matches; advance the pipeline.

        Args:
          track_ids: (n,) int track identifiers (shared across frames).
          uv: (n, 2) measured pixels.
          rows: (n,) image rows for RS (default: uv[:, 1]).

        Returns a step-report dict (event, #matches, #new points, BA
        summary when one ran, and ``wall_s``: seconds by stage, each the
        seconds of the stage's span, ``utils/trace.py``).
        """
        track_ids = np.asarray(track_ids, np.int64)
        with trace.span("frame", frame=self.n_frames,
                        matches=len(track_ids)):
            return self._add_frame(track_ids, uv, rows)

    def _add_frame(self, track_ids, uv, rows) -> dict:
        uv = np.asarray(uv, np.float64)
        rows = (np.asarray(uv[:, 1], np.float64) if rows is None
                else np.asarray(rows, np.float64))
        f = self.n_frames
        frame_obs = []
        for tid, p, r in zip(track_ids, uv, rows):
            tr = self.tracks.setdefault(
                int(tid), {"frames": [], "uv": [], "rows": [],
                           "n_reg": 0, "pooled": set()})
            frame_obs.append((int(tid), len(tr["frames"])))
            tr["frames"].append(f)
            tr["uv"].append(p)
            tr["rows"].append(r)
        self._frame_obs.append(frame_obs)
        self._pooled_frames.append(False)

        if f == 0:
            self.q.append(np.array([1.0, 0, 0, 0]))
            self.c.append(np.zeros(3))
            self.registered.append(True)
            self._on_frame_registered(0)
            report = {"frame": f, "event": "anchor", "wall_s": {}}
            self.log.append(report)
            return report

        # Placeholder pose (previous frame) until registered.
        self.q.append(self.q[-1].copy())
        self.c.append(self.c[-1].copy())
        self.registered.append(False)

        # Each stage ends in a read-back, so the host's clock around it
        # is the stage's wall time on any device.
        if not self.bootstrapped:
            with trace.span("bootstrap") as sp:
                report = self._try_bootstrap(f)
            report["wall_s"] = {"bootstrap": sp.seconds}
        else:
            with trace.span("register") as sp:
                report = self._register(f)
            wall = report["wall_s"] = {"register": sp.seconds}
            if report.get("registered"):
                with trace.span("triangulate") as sp:
                    report["new_points"] = self._triangulate_new()
                    sp.set(new_points=report["new_points"])
                wall["triangulate"] = sp.seconds
                if (f % self.ba_interval) == 0:
                    with trace.span("ba") as sp:
                        s = self.bundle_adjust(window=self.window)
                    wall["ba"] = sp.seconds
                    report["ba"] = s.brief_report()
        self.log.append(report)
        return report

    def bundle_adjust(self, window: Optional[int] = None):
        """Windowed (or full, window=None) BA over the current map.

        Frames outside the window and the two gauge frames are constant;
        map points observed by a free frame are free.  Updates the
        session state in place and returns the solver Summary.
        """
        with trace.span("ba.build") as sp:
            problem, params0, index = self._build_problem(window)
            sp.set(observations=index["observations"])
        params, summary = lm.solve(problem, params0, self.options)
        self.ba_log.append({
            "frames": self.n_frames, "window": window,
            "engine": f"{summary.linear_solver}/{summary.evaluator}",
            "termination": summary.termination,
            "iterations": summary.num_iterations,
            "wall_s": summary.total_time})
        with trace.span("ba.readback"):
            qs = self._host(params.q)
            cs = self._host(params.c)
            for i, fidx in enumerate(index["frames"]):
                self.q[fidx] = qs[i]
                self.c[fidx] = cs[i]
            if index.get("virtual"):
                # the virtual end pose sits right after the real frames
                # (shape-bucketing may append dummy poses behind it)
                vi = len(index["frames"])
                self.q_virtual, self.c_virtual = qs[vi], cs[vi]
            pts = self._host(params.points)
            for i, tid in enumerate(index["tids"]):
                self.points[tid] = pts[i]
        return summary

    def reconstruction(self):
        """(q (F,4), c (F,3), {tid: xyz}) — current estimate."""
        return np.stack(self.q), np.stack(self.c), dict(self.points)

    # --- internals ------------------------------------------------------

    def _dev(self, a) -> torch.Tensor:
        """Host array → tensor on the session's device and dtype."""
        return torch.as_tensor(np.asarray(a),
                               device=self.device).to(self.dtype)

    @staticmethod
    def _host(t, dtype=np.float64) -> np.ndarray:
        return t.detach().cpu().numpy().astype(dtype)

    def _gs(self) -> CameraModel:
        return CameraModel(rolling_shutter=False,
                           use_distortion=self.model.use_distortion,
                           projection_sign=self.model.projection_sign)

    # --- incremental bookkeeping (O(new work) per event) -----------------

    def _frame_usable(self, fidx: int) -> bool:
        """Observations of ``fidx`` are solver-ready forever: the frame is
        registered and (RS) so is its REAL successor keyframe.  The
        newest frame (successor = virtual end pose) is handled as a
        per-build tail instead — its pose_b index is not yet stable."""
        if not self.registered[fidx]:
            return False
        if not self.model.rolling_shutter:
            return True
        return fidx + 1 < self.n_frames and self.registered[fidx + 1]

    def _pool_obs(self, tid: int, i: int) -> None:
        tr = self.tracks[tid]
        if i in tr["pooled"]:
            return
        tr["pooled"].add(i)
        fidx = tr["frames"][i]
        rs = self.model.rolling_shutter
        H = float(self.image_size[1])
        self._pool["tid"].append(tid)
        self._pool["pa"].append(fidx)
        self._pool["pb"].append(fidx + 1 if rs else fidx)
        self._pool["uv"].append(tr["uv"][i])
        self._pool["t"].append(
            np.clip(tr["rows"][i], 0, H) / H if rs else 0.0)

    def _on_point_added(self, tid: int) -> None:
        """Track triangulated: pool its already-usable observations."""
        self._dirty.discard(tid)
        tr = self.tracks[tid]
        for i, fidx in enumerate(tr["frames"]):
            if self._frame_usable(fidx):
                self._pool_obs(tid, i)

    def _on_frame_registered(self, f: int) -> None:
        """Counters + dirty set + obs pool updates after frame f
        registers — O(observations of the affected frames)."""
        for tid, _ in self._frame_obs[f]:
            tr = self.tracks[tid]
            tr["n_reg"] += 1
            if tid not in self.points and tr["n_reg"] >= self.min_views:
                self._dirty.add(tid)
        rs = self.model.rolling_shutter
        for h in ((f - 1, f) if rs else (f,)):
            if (0 <= h < self.n_frames and not self._pooled_frames[h]
                    and self._frame_usable(h)):
                self._pooled_frames[h] = True
                for tid, i in self._frame_obs[h]:
                    if tid in self.points:
                        self._pool_obs(tid, i)

    def _try_bootstrap(self, f: int) -> dict:
        common = [tid for tid, tr in self.tracks.items()
                  if 0 in tr["frames"] and f in tr["frames"]]
        if len(common) < self.min_common:
            return {"frame": f, "event": "bootstrap_deferred",
                    "common": len(common)}
        uv0 = np.stack([self.tracks[t]["uv"][self.tracks[t]["frames"]
                                             .index(0)] for t in common])
        uvf = np.stack([self.tracks[t]["uv"][self.tracks[t]["frames"]
                                             .index(f)] for t in common])
        q2, c2, X, good, quality = epipolar.two_view_init(
            self._dev(uv0), self._dev(uvf), self._dev(self.intr),
            self._dev(np.ones(len(common))), self._gs())
        # one read-back: pose, quality, the points and their validity
        packed = self._host(torch.cat([
            q2, c2, quality.to(X.dtype)[None], X.reshape(-1),
            good.to(X.dtype)]))
        quality = float(packed[7])
        if quality < 0.6:
            return {"frame": f, "event": "bootstrap_deferred",
                    "quality": quality}
        n = len(common)
        self.q[f] = packed[0:4].copy()
        self.c[f] = packed[4:7].copy()
        self.registered[f] = True
        self._on_frame_registered(f)
        if self.model.rolling_shutter:
            self.q_virtual = self.q[f].copy()
            self.c_virtual = self.c[f].copy()
        X_np = packed[8:8 + 3 * n].reshape(n, 3)
        good_np = packed[8 + 3 * n:] > 0
        for i, tid in enumerate(common):
            if good_np[i]:
                self.points[tid] = X_np[i]
                self._on_point_added(tid)
        self.bootstrapped = True
        # Register any intermediate frames that were deferred.
        for g in range(1, f):
            self._register(g)
        self._triangulate_new()
        s = self.bundle_adjust(window=None)
        return {"frame": f, "event": "bootstrap",
                "points": len(self.points), "quality": quality,
                "ba": s.brief_report()}

    def _frame_map_matches(self, f: int):
        tids, uvs, rws = [], [], []
        for tid, i in self._frame_obs[f]:
            if tid in self.points:
                tr = self.tracks[tid]
                tids.append(tid)
                uvs.append(tr["uv"][i])
                rws.append(tr["rows"][i])
        if not tids:
            return None
        return (np.stack([self.points[t] for t in tids]),
                np.stack(uvs), np.asarray(rws), tids)

    def _register(self, f: int) -> dict:
        """Register frame f.

        Rolling shutter runs the full RS register_frame: the estimated
        (row-0, row-H) pose pair IS the session's (frame pose, virtual
        end pose), and the previous frame's end pose is the natural prior
        for this frame's start — the zero-velocity video-tracking seed,
        one inter-frame motion better than the previous *start* pose.
        """
        m = self._frame_map_matches(f)
        if m is None or m[0].shape[0] < 4:
            return {"frame": f, "event": "register_failed",
                    "matches": 0 if m is None else int(m[0].shape[0]),
                    "registered": False}
        pts3d, uv, rows, _ = m
        rs = self.model.rolling_shutter
        H = int(self.image_size[1])
        reg_model = self.model if rs else self._gs()
        prior_ok = f > 0 and self.registered[f - 1]
        # The virtual end pose is the zero-velocity prior for the NEWEST
        # frame only; during bootstrap backfill (f < n_frames-1) it holds
        # the frontier frame's pose, not this frame's neighbor's — seed
        # backfilled frames from frame f-1 instead.
        if (prior_ok and rs and self.q_virtual is not None
                and f == self.n_frames - 1):
            q0, c0 = self.q_virtual, self.c_virtual
        else:
            q0, c0 = self.q[f - 1], self.c[f - 1]
        registered = False
        qb = cb = None
        if prior_ok:
            with trace.span("register.prior"):
                qa, ca, qb, cb, s = register_frame(
                    pts3d, uv, rows, self.intr, reg_model, q0, c0,
                    image_height=H if rs else None,
                    loss=self.loss, options=self.register_options,
                    dtype=self.dtype, device=self.device)
            if s.final_rmse_inlier <= 2.0 * self.inlier_threshold:
                registered = True
                method = "pnp_prior"
        if not registered:
            try:
                with trace.span("register.ransac"):
                    qa, ca, qb, cb, _, info = ransac_pnp(
                        pts3d, uv, self.intr, reg_model,
                        rows=rows if rs else None,
                        image_height=H if rs else None,
                        inlier_threshold=self.inlier_threshold,
                        seed=self.seed + f, loss=self.loss,
                        options=self.register_options,
                        dtype=self.dtype, device=self.device)
                registered = True
                method = "ransac"
            except ValueError:
                return {"frame": f, "event": "register_failed",
                        "matches": int(pts3d.shape[0]),
                        "registered": False}
        pose = self._host(torch.cat([qa, ca, qb, cb]))   # one read-back
        self.q[f] = pose[0:4].copy()
        self.c[f] = pose[4:7].copy()
        self.registered[f] = True
        self._on_frame_registered(f)
        if rs and f == self.n_frames - 1:
            self.q_virtual = pose[7:11].copy()
            self.c_virtual = pose[11:14].copy()
        self.n_registered_by[method] += 1
        return {"frame": f, "event": "register", "method": method,
                "matches": int(pts3d.shape[0]), "registered": True}

    def _triangulate_new(self) -> int:
        """Triangulate tracks that now have ≥ min_views registered views.

        Candidates come from the dirty set maintained by
        ``_on_frame_registered`` (tracks whose registered-view count
        crossed ``min_views``); tracks that fail the quality gates stay
        dirty and are retried as more views register."""
        H = float(self.image_size[1])
        cands = [tid for tid in sorted(self._dirty)
                 if tid not in self.points]
        if not cands:
            return 0
        L = max(self.tracks[t]["n_reg"] for t in cands)
        n_c = len(cands)
        if self.shape_buckets:
            L = -(-L // 4) * 4
            n_c = n_c + (-n_c % 256)
        F = self.n_frames
        qa = np.zeros((n_c, L, 4)); qa[..., 0] = 1.0
        ca = np.zeros((n_c, L, 3))
        qb = qa.copy(); cb = ca.copy()
        uv = np.zeros((n_c, L, 2))
        tt = np.zeros((n_c, L))
        mask = np.zeros((n_c, L))
        for k, tid in enumerate(cands):
            tr = self.tracks[tid]
            j = 0
            for i, fidx in enumerate(tr["frames"]):
                if not self.registered[fidx]:
                    continue
                if not self.model.rolling_shutter:
                    q_nxt, c_nxt = self.q[fidx], self.c[fidx]
                elif fidx + 1 < F and self.registered[fidx + 1]:
                    q_nxt, c_nxt = self.q[fidx + 1], self.c[fidx + 1]
                elif fidx == F - 1 and self.q_virtual is not None:
                    q_nxt, c_nxt = self.q_virtual, self.c_virtual
                else:
                    q_nxt, c_nxt = self.q[fidx], self.c[fidx]
                qa[k, j] = self.q[fidx]; ca[k, j] = self.c[fidx]
                qb[k, j] = q_nxt; cb[k, j] = c_nxt
                uv[k, j] = tr["uv"][i]
                tt[k, j] = (np.clip(tr["rows"][i], 0, H) / H
                            if self.model.rolling_shutter else 0.0)
                mask[k, j] = 1.0
                j += 1
        args = tuple(self._dev(a)
                     for a in (qa, ca, qb, cb, self.intr, uv, tt, mask))
        X, valid = triangulate.triangulate(*args, self.model,
                                           min_depth=1e-3)
        err = triangulate.reprojection_error(*args, self.model, X)
        ok = valid & (err <= 2.0 * self.inlier_threshold)
        # one read-back: the points and their acceptance
        packed = self._host(torch.cat([X, ok.to(X.dtype)[:, None]], dim=1))
        X_np, ok = packed[:, :3], packed[:, 3] > 0
        n_new = 0
        for k, tid in enumerate(cands):
            if ok[k]:
                self.points[tid] = X_np[k]
                self._on_point_added(tid)
                n_new += 1
        return n_new

    def _build_problem(self, window: Optional[int]):
        """Flat Problem over registered frames and triangulated tracks.

        Observations = the append-only pool (stable obs: frame AND RS
        successor registered, pooled incrementally by the event hooks)
        + the newest frame's tail (successor = virtual end pose, whose
        index grows with the sequence, so it cannot live in the pool) —
        no track rescan.
        """
        F = self.n_frames
        H = float(self.image_size[1])
        rs = self.model.rolling_shutter
        tids = sorted(self.points.keys())
        tids_np = np.asarray(tids, np.int64)
        rows_tid = list(self._pool["tid"])
        rows_pa = list(self._pool["pa"])
        rows_pb = list(self._pool["pb"])
        rows_uv = list(self._pool["uv"])
        rows_t = list(self._pool["t"])
        g = F - 1
        if (rs and g >= 0 and self.registered[g]
                and not self._pooled_frames[g]):
            for tid, i in self._frame_obs[g]:
                tr = self.tracks[tid]
                if tid in self.points and i not in tr["pooled"]:
                    rows_tid.append(tid)
                    rows_pa.append(g)
                    rows_pb.append(g + 1)       # virtual end pose index
                    rows_uv.append(tr["uv"][i])
                    rows_t.append(np.clip(tr["rows"][i], 0, H) / H)
        rows_pt = np.searchsorted(tids_np, np.asarray(rows_tid, np.int64))
        N = len(rows_pa)
        n_pad = -N % (2048 if self.shape_buckets else 64)
        dt = self.dtype

        def pad(a, fill=0):
            a = np.asarray(a)
            return np.concatenate(
                [a, np.full((n_pad,) + a.shape[1:], fill, a.dtype)])

        P = F + 1 if rs else F          # +1: virtual end pose (RS)
        n_tid = len(tids)
        uv_np = pad(np.asarray(rows_uv, np.float64)).astype(np.float64)
        t_np = pad(np.asarray(rows_t, np.float64))
        pa_np_p = pad(np.asarray(rows_pa, np.int32))
        pb_np_p = pad(np.asarray(rows_pb, np.int32))
        pt_np_p = pad(np.asarray(rows_pt, np.int32))
        mask_np = pad(np.ones(N))
        # Shape buckets: dummy constant poses and points, which no
        # observation refers to, round the parameter counts up.
        P_pad = (-P % 8) if self.shape_buckets else 0
        M_pad = (-n_tid % 256) if self.shape_buckets else 0
        as_i = lambda a: torch.as_tensor(  # noqa: E731
            a, dtype=torch.int32, device=self.device)
        obs = Observations(
            uv=self._dev(uv_np), t=self._dev(t_np),
            pose_a=as_i(pa_np_p), pose_b=as_i(pb_np_p),
            intr_idx=torch.zeros(N + n_pad, dtype=torch.int32,
                                 device=self.device),
            point=as_i(pt_np_p), mask=self._dev(mask_np))
        problem = make_problem(obs, P + P_pad, n_tid + M_pad, 1,
                               self.model, self.loss,
                               intr_basis=intr_basis_fixed(), dtype=dt,
                               device=self.device)
        # Free masks: window frames free; gauge = the first registered
        # frame constant (6 dof).  The remaining scale freedom is left to
        # LM damping (free-gauge BA) rather than pinning a second pose:
        # under RS the bootstrap pair's relative pose is GS-biased, and a
        # hard-fixed second pose would freeze that bias into the map.
        pose_free = np.array(self.registered, np.float64)
        if window is not None:
            pose_free[:max(F - window, 0)] = 0.0
        gauge = [i for i in range(F) if self.registered[i]][:1]
        pose_free[gauge] = 0.0
        if rs:      # virtual end pose follows the last frame's freedom
            pose_free = np.concatenate([pose_free, pose_free[-1:]])
        if P_pad:
            pose_free = np.concatenate([pose_free, np.zeros(P_pad)])
        pt_free = np.zeros(n_tid + M_pad)
        free_frames = np.nonzero(pose_free)[0]
        pa_np = np.asarray(rows_pa)
        pt_np = np.asarray(rows_pt)
        if window is None:
            pt_free[:n_tid] = 1.0
        else:
            sel = np.isin(pa_np, free_frames)
            pt_free[np.unique(pt_np[sel])] = 1.0
            if free_frames.size == 0:  # all-fixed window → at least points
                pt_free[:n_tid] = 1.0
        problem = problem.replace(pose_free=self._dev(pose_free),
                                  point_free=self._dev(pt_free))
        q_all = list(self.q)
        c_all = list(self.c)
        if rs:
            q_all.append(self.q_virtual if self.q_virtual is not None
                         else self.q[-1])
            c_all.append(self.c_virtual if self.c_virtual is not None
                         else self.c[-1])
        for _ in range(P_pad):
            q_all.append(np.array([1.0, 0, 0, 0]))
            c_all.append(np.zeros(3))
        pts = np.stack([self.points[t] for t in tids]) if tids else \
            np.zeros((0, 3))
        if M_pad:
            pts = np.concatenate([pts, np.ones((M_pad, 3))])
        params0 = Params(q=self._dev(np.stack(q_all)),
                         c=self._dev(np.stack(c_all)),
                         intr=self._dev(self.intr[None, :]),
                         points=self._dev(pts))
        return problem, params0, {"frames": list(range(F)), "tids": tids,
                                  "virtual": rs, "observations": N}
