"""Traffic kind ``session``: a video handed frame by frame to
``rsba_tpu_torch.pipeline.SfmSession``.

A closed loop: each frame's matches go to ``add_frame`` as soon as the
previous frame's call has returned (and the card has finished).  When
the sequence runs out inside the window, a fresh session starts on the
same sequence, its bootstrap included.  Every run gets the same
sequence, so that every run does the same work; set-up warms up on the
first ``warmup_frames`` frames of a sequence made from ``--seed``.

Traffic parameters (``traffic/<name>.json``):
  sequence_seed  the generator's seed of the measured sequence
  warmup_frames  frames of the warm-up sequence
  trace_from     first frame of the profiled slice in a traced run
  trace_frames   frames in the profiled slice

``correct``: once the window has closed, every session of the window is
held, as it stood at its last frame, to the generator's ground truth and
to the plain geometry in float64: each frame that raised or that is not
registered is ``failed``; ``rot_err_rad`` is the largest error of the
rotation between
consecutive registered frames (a similarity of the reconstruction leaves
it unchanged).  Every observation of a triangulated point in a frame
whose two keyframe poses are registered is reprojected:
``frame_rmse_max_px`` is the largest RMS error of one frame's
observations, and ``bad_point_share`` the share of the points whose
observations' RMS error lies past the session's inlier gate (3 × its
Huber scale).

The control (``--control bf16``) hands the check the session's poses and
points rounded through bfloat16, the precision below the configuration's
float32.
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from ..reference import generator
from ..reference import geometry as geo


@dataclasses.dataclass
class State:
    cfg: dict
    scene: object
    frames: list
    make_session: object
    traffic: dict
    control: str
    #: (frames ingested, q (F, 4), c (F, 3), registered (F,), {tid: xyz})
    #: of each session of the window, taken at its last frame
    snapshots: list = dataclasses.field(default_factory=list)


def _session_factory(cfg: dict, scene, device):
    from rsba_tpu_torch.geometry import CameraModel, Loss
    from rsba_tpu_torch.pipeline import SfmSession
    from rsba_tpu_torch.solver.options import SolverOptions
    s = cfg["session"]
    options = SolverOptions(**s["solver"])
    m = scene.model
    model = CameraModel(rolling_shutter=m["rolling_shutter"],
                        rotation_interp=m["interp"],
                        use_distortion=m["distortion"])
    loss = Loss(s["loss"]["kind"], float(s["loss"]["scale"]))

    def make():
        return SfmSession(scene.intr[0], model, scene.image_size,
                          window=s["window"], ba_interval=s["ba_interval"],
                          loss=loss, options=options,
                          dtype=getattr(torch, cfg["dtype"]),
                          shape_buckets=s["shape_buckets"], device=device)
    return make


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def setup(cfg: dict, traffic: dict, seed: int, device, control: str) -> State:
    warm_seed = int(np.random.SeedSequence(seed).generate_state(1)[0])
    scene = generator.make_scene(cfg["generator"], traffic["sequence_seed"],
                                 device)
    warm = generator.make_scene(cfg["generator"], warm_seed, device)
    make = _session_factory(cfg, scene, device)
    sess = make()
    for pid, uv in generator.frames_of(warm)[:traffic["warmup_frames"]]:
        sess.add_frame(pid, uv, rows=uv[:, 1])
    _sync(device)
    return State(cfg, scene, generator.frames_of(scene), make, traffic,
                 control)


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded through bfloat16."""
    return torch.as_tensor(a).to(torch.bfloat16).double().numpy()


def _snapshot(st: State, sess) -> tuple:
    q, c, pts = sess.reconstruction()
    if st.control == "bf16":
        q, c = _bf16(q), _bf16(c)
        keys = list(pts)
        if keys:
            pts = dict(zip(keys, _bf16(np.stack([pts[k] for k in keys]))))
    return (sess.n_frames, q, c, np.asarray(sess.registered), pts)


def window(st: State, seconds: float, run, tracer) -> None:
    from rsba_tpu_torch.solver import lm_device
    device = None
    a = st.traffic["trace_from"]
    b = a + st.traffic["trace_frames"]
    t_start = time.perf_counter()
    sess, f, n = None, 0, 0
    while True:
        if sess is None or f == len(st.frames):
            if sess is not None:
                st.snapshots.append(_snapshot(st, sess))
            sess, f = st.make_session(), 0
            device = sess.device
            if tracer.enabled:
                _span_bundle_adjust(sess, tracer)
        if tracer.enabled and n == a:
            tracer.start()
        pid, uv = st.frames[f]
        cap0 = lm_device._Runner.capture_seconds
        rec = {"frame": f, "ok": False}
        t0 = time.perf_counter()
        try:
            with tracer.span("add_frame"):
                report = sess.add_frame(pid, uv, rows=uv[:, 1])
                _sync(device)
            rec["wall_s"] = time.perf_counter() - t0
            rec["stages"] = dict(report.get("wall_s", {}))
            rec["ok"] = True
        except Exception as e:                       # noqa: BLE001
            rec["wall_s"] = time.perf_counter() - t0
            rec["error"] = f"{type(e).__name__}: {e}"
        rec["capture_s"] = lm_device._Runner.capture_seconds - cap0
        run.frames.append(rec)
        run.failed += 0 if rec["ok"] else 1
        f += 1
        n += 1
        if tracer.active and n >= b:
            tracer.stop()
        if time.perf_counter() - t_start >= seconds:
            break
    run.window_s = time.perf_counter() - t_start
    tracer.stop()
    st.snapshots.append(_snapshot(st, sess))


def _span_bundle_adjust(sess, tracer) -> None:
    """Mark the session's bundle adjustments as spans ``ba`` (inside the
    ``add_frame`` spans) in a traced run."""
    inner = sess.bundle_adjust

    def bundle_adjust(*args, **kw):
        with tracer.span("ba"):
            return inner(*args, **kw)
    sess.bundle_adjust = bundle_adjust


def release(st: State) -> None:
    st.make_session = None


def _rel(q: torch.Tensor) -> torch.Tensor:
    """Rotation from each frame to the next: q_{f+1} ⊗ q_f⁻¹."""
    return geo.qmul(q[1:], geo.qconj(q[:-1]))


def _group_ms(s: torch.Tensor, group: torch.Tensor, n: int) -> torch.Tensor:
    """Mean of ``s`` within each group that has members."""
    total = torch.zeros(n, dtype=s.dtype, device=s.device)
    count = torch.zeros_like(total)
    total.index_add_(0, group, s)
    count.index_add_(0, group, torch.ones_like(s))
    seen = count > 0
    return total[seen] / count[seen]


def check(st: State, run, limits: dict, device) -> list:
    sc = st.scene
    gate = 3.0 * float(st.cfg["session"]["loss"]["scale"])
    f64 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64,  # noqa: E731
                                    device=device)
    q_gt = f64(sc.gt["q"])
    valid = sc.mask > 0
    pa, pid = sc.pose_a[valid], sc.point[valid]
    uv, t = sc.uv[valid], sc.t[valid]
    unregistered, rot_err, frame_rmse = 0, 0.0, 0.0
    n_pts, n_bad = 0, 0
    for n_frames, q, c, reg, pts in st.snapshots:
        unregistered += int((~reg).sum())
        q, c = f64(q), f64(c)
        both = torch.as_tensor(reg[:-1] & reg[1:], device=device)
        d = geo.qmul(_rel(q), geo.qconj(_rel(q_gt[:n_frames])))
        ang = 2.0 * torch.atan2(torch.linalg.vector_norm(d[:, 1:], dim=-1),
                                d[:, 0].abs())
        if bool(both.any()):
            rot_err = max(rot_err, float(ang[both].max()))
        # Observations whose frame and successor keyframe are registered
        # and whose track is a triangulated point.
        tid = np.fromiter(pts.keys(), np.int64, len(pts))
        if not len(tid):
            continue
        xyz = np.stack([pts[k] for k in tid])
        lut = np.full(sc.n_points, -1, np.int64)
        lut[tid] = np.arange(len(tid))
        regx = np.concatenate([reg, [False]])
        sel = ((pa + 1 < n_frames) & regx[np.minimum(pa, n_frames)]
               & regx[np.minimum(pa + 1, n_frames)] & (lut[pid] >= 0))
        ia = torch.as_tensor(pa[sel], device=device)
        ip = torch.as_tensor(lut[pid[sel]], device=device)
        r = geo.project(q[ia], c[ia], q[ia + 1], c[ia + 1], f64(sc.intr[0]),
                        f64(xyz)[ip], f64(t[sel]), sc.model) - f64(uv[sel])
        s = torch.sum(r * r, dim=-1)
        frame_rmse = max(frame_rmse, float(_group_ms(s, ia, n_frames)
                                           .max().sqrt()))
        # A point is bad where the RMS of its observations passes the gate.
        n_pts += int(torch.unique(ip).numel())
        n_bad += int((_group_ms(s, ip, len(tid)) > gate * gate).sum())
    run.failed += unregistered
    return [("failed", float(run.failed), 0.0),
            ("rot_err_rad", rot_err, limits["rot_err_rad"]),
            ("frame_rmse_max_px", frame_rmse if n_pts else math.inf,
             limits["frame_rmse_max_px"]),
            ("bad_point_share", n_bad / n_pts if n_pts else math.inf,
             limits["bad_point_share"])]
