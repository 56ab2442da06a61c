"""Registration building blocks of rsba_tpu_torch against rsba_tpu.

The same numpy inputs, made from a seed, go through the JAX functions and
their counterparts in the port on the CPU in float64: the geometry
additions (rtol 1e-12), ``undistort`` / ``backproject`` / triangulation /
``reprojection_error`` (1e-10), the essential matrix up to sign (1e-8),
``two_view_init`` (1e-7), the closed-form roots as sorted sets (1e-8
relative), ``p3p``'s valid solutions as sets (1e-7), ``register_frame``
(same termination, pose and RMSE at 1e-6) and ``ransac_pnp`` (equal
inlier masks, pose at 1e-6).  ``eigh`` / ``svd`` factors and the order of
the quartic's roots are never compared raw: they differ between LAPACK
and XLA by signs and branches.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsba_tpu.geometry import CameraModel as JModel
from rsba_tpu.geometry import Loss as JLoss
from rsba_tpu.geometry import camera as jcamera
from rsba_tpu.geometry import distortion as jdist
from rsba_tpu.geometry import epipolar as jepi
from rsba_tpu.geometry import quaternion as jquat
from rsba_tpu.geometry import triangulate as jtri
from rsba_tpu.problem import synthetic as jsyn
from rsba_tpu.solver import p3p as jp3p
from rsba_tpu.solver.pnp import register_frame as jregister
from rsba_tpu.solver.ransac import ransac_pnp as jransac
from rsba_tpu_torch.geometry import CameraModel, Loss, intrinsics_vector
from rsba_tpu_torch.geometry import distortion as tdist
from rsba_tpu_torch.geometry import epipolar as tepi
from rsba_tpu_torch.geometry import quaternion as tquat
from rsba_tpu_torch.geometry import triangulate as ttri
from rsba_tpu_torch.solver import p3p as tp3p
from rsba_tpu_torch.solver.pnp import register_frame
from rsba_tpu_torch.solver.ransac import ransac_pnp

torch.set_num_threads(2)
DT = jnp.float64


def T(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def J(a):
    return jnp.asarray(np.asarray(a), DT)


def N(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _models(distortion):
    kw = dict(rolling_shutter=False, use_distortion=distortion)
    return JModel(**kw), CameraModel(**kw)


def _scene(n_cams=4, n_pts=50, seed=0, distortion=False, noise=0.0):
    """The scene of tests/test_registration.py: cameras on an arc looking
    at a cloud at the origin, projected with the JAX camera."""
    rng = np.random.RandomState(seed)
    jm, tm = _models(distortion)
    intr = np.array([800.0, 800.0, 320.0, 240.0,
                     -0.1 if distortion else 0.0,
                     0.02 if distortion else 0.0, 0.0, 0.0, 0.0])
    q, c = [], []
    for i in range(n_cams):
        ang = 0.25 * i
        eye = np.array([2.0 * np.sin(ang), 0.1 * i, -2.0 * np.cos(ang)])
        z = -eye / np.linalg.norm(eye)
        x = np.cross([0, 1, 0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z], axis=0)
        q.append(np.asarray(jquat.from_matrix(J(R))))
        c.append(eye)
    q, c = np.stack(q), np.stack(c)
    pts = rng.randn(n_pts, 3) * 0.5
    uv = np.asarray(jcamera.project_global(
        J(q)[:, None], J(c)[:, None], J(intr), J(pts)[None], jm))
    uv = uv + rng.randn(*uv.shape) * noise
    return jm, tm, intr, q, c, pts, uv


# --- geometry additions -------------------------------------------------------

def test_quaternion_additions_match_reference():
    rng = np.random.RandomState(0)
    q = rng.randn(64, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    v = rng.randn(64, 3)
    d = rng.randn(64, 3) * 0.3
    pairs = [
        (tquat.to_matrix(T(q)), jquat.to_matrix(J(q))),
        (tquat.rotate_inverse(T(q), T(v)), jquat.rotate_inverse(J(q), J(v))),
        (tquat.exp_tangent(T(d)), jquat.exp_tangent(J(d))),
        (tquat.log(T(q)), jquat.log(J(q))),
        (tquat.from_matrix(tquat.to_matrix(T(q))),
         jquat.from_matrix(jquat.to_matrix(J(q)))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(N(got), np.asarray(want), rtol=1e-12,
                                   atol=1e-14)
    back = tquat.from_matrix(tquat.to_matrix(T(q)))
    np.testing.assert_allclose(np.abs(np.sum(N(back) * q, axis=1)), 1.0,
                               atol=1e-12)
    np.testing.assert_array_equal(
        intrinsics_vector(900.0, cx=3.0, k1=-0.1),
        np.asarray(jcamera.intrinsics_vector(900.0, cx=3.0, k1=-0.1)))


@pytest.mark.parametrize("aa", [
    [np.pi, 0.0, 0.0], [0.0, np.pi, 0.0], [0.0, 0.0, np.pi],
    [np.pi / np.sqrt(2), np.pi / np.sqrt(2), 0.0],
    [np.pi - 1e-9, 0.0, 0.0]])
def test_from_matrix_180deg_matches_reference(aa):
    """Half turns: the trace pivot vanishes and another branch is taken."""
    qj = jquat.from_axis_angle(J(aa))
    want = np.asarray(jquat.from_matrix(jquat.to_matrix(qj)))
    got = N(tquat.from_matrix(tquat.to_matrix(T(np.asarray(qj)))))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    assert abs(np.sum(got * np.asarray(qj))) == pytest.approx(1.0, abs=1e-12)


def test_undistort_and_backproject_match_reference():
    rng = np.random.RandomState(1)
    xy = rng.uniform(-0.5, 0.5, (200, 2))
    k = np.array([-0.15, 0.03, 1e-3, -2e-3, 0.01])
    got = tdist.undistort(T(xy), T(k))
    np.testing.assert_allclose(N(got), np.asarray(jdist.undistort(J(xy),
                                                                  J(k))),
                               rtol=1e-10, atol=1e-12)
    # it inverts distort
    np.testing.assert_allclose(N(tdist.distort(got, T(k))), xy, atol=1e-8)
    intr = np.array([800.0, 790.0, 320.0, 240.0, *k])
    uv = rng.uniform(0, 640, (200, 2))
    for sign in (1.0, -1.0):
        kw = dict(use_distortion=True, projection_sign=sign)
        np.testing.assert_allclose(
            N(ttri.backproject(T(uv), T(intr), CameraModel(**kw))),
            np.asarray(jtri.backproject(J(uv), J(intr), JModel(**kw))),
            rtol=1e-10, atol=1e-12)


# --- triangulation ------------------------------------------------------------

def test_triangulate_gs_matches_reference():
    jm, tm, intr, q, c, pts, uv = _scene(n_cams=4, distortion=True,
                                         noise=0.3)
    M, L = pts.shape[0], q.shape[0]
    qa = np.broadcast_to(q[None], (M, L, 4))
    ca = np.broadcast_to(c[None], (M, L, 3))
    mask = np.ones((M, L))
    mask[::5, 3] = 0.0
    mask[1::7, 1:] = 0.0            # a single view: invalid
    uvm = uv.transpose(1, 0, 2)
    zeros = np.zeros((M, L))
    Xj, vj = jtri.triangulate(J(qa), J(ca), J(qa), J(ca), J(intr), J(uvm),
                              J(zeros), J(mask), jm, min_depth=1e-3)
    Xt, vt = ttri.triangulate(T(qa), T(ca), T(qa), T(ca), T(intr), T(uvm),
                              T(zeros), T(mask), tm, min_depth=1e-3)
    np.testing.assert_array_equal(N(vt), np.asarray(vj))
    assert 0 < N(vt).sum() < M
    np.testing.assert_allclose(N(Xt), np.asarray(Xj), rtol=1e-10, atol=1e-10)
    ej = jtri.reprojection_error(J(qa), J(ca), J(qa), J(ca), J(intr), J(uvm),
                                 J(zeros), J(mask), jm, Xj)
    et = ttri.reprojection_error(T(qa), T(ca), T(qa), T(ca), T(intr), T(uvm),
                                 T(zeros), T(mask), tm, Xt)
    np.testing.assert_allclose(N(et), np.asarray(ej), rtol=1e-8, atol=1e-10)
    # rays alone, with parallel rays flagged and no NaN
    org = np.broadcast_to(c[None, :2], (M, 2, 3))
    dirs = np.broadcast_to(np.array([0.0, 0.0, 1.0]), (M, 2, 3))
    Xr, vr = ttri.triangulate_rays(T(org), T(dirs), T(np.ones((M, 2))))
    Xrj, vrj = jtri.triangulate_rays(J(org), J(dirs), J(np.ones((M, 2))))
    assert not N(vr).any() and not np.asarray(vrj).any()
    assert np.isfinite(N(Xr)).all()


def test_triangulate_rs_matches_reference():
    """Rolling shutter: rays from the pose interpolated at each row time,
    on tracks of a small video problem."""
    ba = jsyn.CONFIGS["rs_video_linear"](scale=0.05, seed=3, dtype=DT)
    obs, gt = ba.problem.obs, ba.params_gt
    m = np.asarray(obs.mask) > 0
    pid = np.asarray(obs.point)[m]
    order = np.argsort(pid, kind="stable")
    counts = np.bincount(pid, minlength=gt.points.shape[0])
    sel = np.nonzero(counts >= 3)[0][:40]
    L = int(counts[sel].max())
    offs = np.cumsum(counts) - counts
    rows = np.nonzero(m)[0][order]

    def gather(field, fill=0):
        out = np.full((len(sel), L) + np.asarray(field).shape[1:], fill,
                      np.asarray(field).dtype)
        for k, p in enumerate(sel):
            out[k, :counts[p]] = np.asarray(field)[
                rows[offs[p]:offs[p] + counts[p]]]
        return out

    pa, pb = gather(obs.pose_a), gather(obs.pose_b)
    qg, cg = np.asarray(gt.q), np.asarray(gt.c)
    mask = (np.arange(L)[None, :] < counts[sel][:, None]).astype(float)
    args = (qg[pa], cg[pa], qg[pb], cg[pb], np.asarray(gt.intr[0]),
            gather(obs.uv), gather(obs.t), mask)
    jm = ba.problem.model
    tm = CameraModel(rolling_shutter=True, rotation_interp="nlerp",
                     use_distortion=jm.use_distortion)
    Xj, vj = jtri.triangulate(*(J(a) for a in args), jm)
    Xt, vt = ttri.triangulate(*(T(a) for a in args), tm)
    np.testing.assert_array_equal(N(vt), np.asarray(vj))
    assert N(vt).mean() > 0.9
    np.testing.assert_allclose(N(Xt), np.asarray(Xj), rtol=1e-10, atol=1e-10)
    ej = jtri.reprojection_error(*(J(a) for a in args), jm, Xj)
    et = ttri.reprojection_error(*(T(a) for a in args), tm, Xt)
    np.testing.assert_allclose(N(et), np.asarray(ej), rtol=1e-8, atol=1e-9)


# --- two-view bootstrap -------------------------------------------------------

def test_essential_matches_reference_up_to_sign():
    jm, tm, intr, q, c, pts, uv = _scene(n_cams=2, n_pts=60, noise=0.2)
    mask = np.ones(60)
    mask[::9] = 0.0
    d1 = jtri.backproject(J(uv[0]), J(intr), jm)
    d2 = jtri.backproject(J(uv[1]), J(intr), jm)
    Ej = np.asarray(jepi.essential_from_rays(d1, d2, J(mask)))
    Et = N(tepi.essential_from_rays(T(np.asarray(d1)), T(np.asarray(d2)),
                                    T(mask)))
    sign = np.sign(np.sum(Ej * Et))
    np.testing.assert_allclose(sign * Et, Ej, atol=1e-8)
    # on the essential manifold: singular values (1, 1, 0)
    np.testing.assert_allclose(np.linalg.svd(Et)[1], [1.0, 1.0, 0.0],
                               atol=1e-12)
    Ra, Rb, t = tepi.decompose_essential(T(Et))
    for R in (Ra, Rb):
        np.testing.assert_allclose(N(R @ R.T), np.eye(3), atol=1e-12)
        assert float(torch.linalg.det(R)) == pytest.approx(1.0, abs=1e-12)
    assert float(torch.linalg.vector_norm(t)) == pytest.approx(1.0)


@pytest.mark.parametrize("distortion,seed", [(False, 0), (True, 3)])
def test_two_view_init_matches_reference(distortion, seed):
    jm, tm, intr, q, c, pts, uv = _scene(n_cams=2, n_pts=60, seed=seed,
                                         distortion=distortion, noise=0.2)
    mask = np.ones(60)
    qj, cj, Xj, gj, quj = jepi.two_view_init(J(uv[0]), J(uv[1]), J(intr),
                                             J(mask), jm)
    # numpy inputs: placed by the entry point, on the CPU when asked
    qt, ct, Xt, gt, qut = tepi.two_view_init(uv[0], uv[1], intr, mask, tm,
                                             device="cpu")
    assert qt.dtype == torch.float64 and qt.device.type == "cpu"
    s = np.sign(np.sum(N(qt) * np.asarray(qj)))
    np.testing.assert_allclose(s * N(qt), np.asarray(qj), atol=1e-7)
    np.testing.assert_allclose(N(ct), np.asarray(cj), atol=1e-7)
    np.testing.assert_array_equal(N(gt), np.asarray(gj))
    good = N(gt)
    np.testing.assert_allclose(N(Xt)[good], np.asarray(Xj)[good], atol=1e-7)
    assert float(qut) == float(quj) > 0.9
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            tepi.two_view_init(uv[0], uv[1], intr, mask, tm)


# --- closed-form roots and P3P --------------------------------------------------

def _sorted_roots(r):
    r = np.asarray(N(r))
    return np.take_along_axis(
        r, np.lexsort((np.round(r.imag, 6), np.round(r.real, 6)),
                      axis=-1), axis=-1)


def _coeffs_from_roots(true):
    e = [np.ones(true.shape[0])]
    for k in range(1, 5):
        from itertools import combinations
        e.append(sum(np.prod(true[:, list(idx)], axis=1)
                     for idx in combinations(range(4), k)))
    return [e[0], -e[1], e[2], -e[3], e[4]]


def test_quartic_known_roots_match_reference():
    rng = np.random.RandomState(1)
    true = rng.randn(128, 4)
    cs = _coeffs_from_roots(true)
    rt = tp3p._polish_roots(*(T(x) for x in cs),
                            tp3p.solve_quartic_roots(*(T(x) for x in cs)))
    rj = jp3p._polish_roots(*(J(x) for x in cs),
                            jp3p.solve_quartic_roots(*(J(x) for x in cs)))
    got = np.sort(N(rt).real, axis=1)
    np.testing.assert_allclose(got, np.sort(true, axis=1), atol=1e-7)
    np.testing.assert_allclose(got, np.sort(np.asarray(rj).real, axis=1),
                               rtol=1e-8, atol=1e-8)
    assert np.abs(N(rt).imag).max() < 1e-7


def test_cubic_and_random_quartics_match_reference():
    rng = np.random.RandomState(2)
    B, C, D = rng.randn(3, 256)
    ct = tp3p.solve_cubic_roots(T(B), T(C), T(D))
    cj = jp3p.solve_cubic_roots(J(B), J(C), J(D))
    np.testing.assert_allclose(_sorted_roots(ct), _sorted_roots(cj),
                               rtol=1e-8, atol=1e-8)
    x = N(ct)
    np.testing.assert_allclose(
        x ** 3 + B[:, None] * x ** 2 + C[:, None] * x + D[:, None], 0.0,
        atol=1e-9)
    cs = list(rng.randn(5, 256))
    cs[0][:3] = 0.0                       # degenerate leading coefficient
    qt = tp3p.solve_quartic_roots(*(T(x) for x in cs))
    qj = jp3p.solve_quartic_roots(*(J(x) for x in cs))
    assert np.isnan(N(qt)[:3]).all() and np.isnan(np.asarray(qj)[:3]).all()
    a, b = _sorted_roots(qt[3:]), _sorted_roots(qj[3:])
    scale = np.maximum(np.abs(b), 1.0)
    assert np.max(np.abs(a - b) / scale) < 1e-8
    # float32: complex64 roots, polished, still roots of the polynomial
    c32 = [torch.as_tensor(x[3:], dtype=torch.float32) for x in cs]
    r32 = tp3p._polish_roots(*c32, tp3p.solve_quartic_roots(*c32))
    assert r32.dtype == torch.complex64
    a32 = np.sort(N(r32).real, axis=1)
    assert np.median(np.abs(a32 - np.sort(N(qt[3:]).real, axis=1))) < 1e-4


def test_p3p_valid_solutions_match_reference_as_sets():
    rng = np.random.RandomState(7)
    n = 64
    q_gt = rng.randn(n, 4)
    q_gt /= np.linalg.norm(q_gt, axis=1, keepdims=True)
    c_gt = rng.randn(n, 3)
    depths = rng.uniform(2.0, 6.0, (n, 3))
    dirs = rng.randn(n, 3, 3)
    dirs[..., 2] = np.abs(dirs[..., 2]) + 1.0
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    X = c_gt[:, None, :] + np.asarray(jquat.rotate_inverse(
        J(q_gt)[:, None, :], J(depths[..., None] * dirs)))
    qj, cj, vj = (np.asarray(a) for a in jp3p.p3p(J(dirs), J(X)))
    qt, ct, vt = (N(a) for a in tp3p.p3p(T(dirs), T(X)))
    assert vt.any(axis=-1).all()
    np.testing.assert_array_equal(vt.sum(axis=-1), vj.sum(axis=-1))
    for i in range(n):
        # each side's valid solutions, sorted by camera centre
        def ordered(q, c, v):
            q, c = q[v], c[v]
            q = q * np.sign(q[:, :1] + 1e-300)
            o = np.lexsort(np.round(c, 5).T[::-1])
            return q[o], c[o]
        a_q, a_c = ordered(qt[i], ct[i], vt[i])
        b_q, b_c = ordered(qj[i], cj[i], vj[i])
        np.testing.assert_allclose(a_c, b_c, atol=1e-7)
        np.testing.assert_allclose(np.abs(np.sum(a_q * b_q, axis=1)), 1.0,
                                   atol=1e-7)
    # one of the solutions is the true pose
    dq = np.abs(np.sum(qt * q_gt[:, None, :], axis=-1))
    dc = np.linalg.norm(ct - c_gt[:, None, :], axis=-1)
    assert (vt & (dq > 1 - 1e-6) & (dc < 1e-5)).any(axis=-1).all()
    # invalid slots hold the identity and the origin
    np.testing.assert_array_equal(qt[~vt], np.broadcast_to(
        [1.0, 0, 0, 0], qt[~vt].shape))
    assert not ct[~vt].any()
    # degenerate input (coincident points) is invalid, not NaN
    qd, cd, vd = tp3p.p3p(T(dirs[:2]), T(np.zeros((2, 3, 3))))
    assert not N(vd).any() and np.isfinite(N(qd)).all()


# --- PnP registration ---------------------------------------------------------

@pytest.fixture(scope="module")
def seq():
    return jsyn.make_ba_problem(
        n_poses=9, n_points=120, track_len=5, rolling_shutter=True,
        rotation_interp="nlerp", use_distortion=False, pixel_noise=0.4,
        seed=7, dtype=DT, pad_to=32)


def _frame_obs(ba, k):
    obs = ba.problem.obs
    idx = np.nonzero(np.asarray((obs.pose_a == k) & (obs.mask > 0)))[0]
    return (np.asarray(ba.params_gt.points)[np.asarray(obs.point)[idx]],
            np.asarray(obs.uv)[idx])


def _close_pose(got, want, tol=1e-6):
    got, want = N(got), np.asarray(want)
    if got.shape[-1] == 4:
        got = got * np.sign(np.sum(got * want))
    np.testing.assert_allclose(got, want, atol=tol)


def test_register_frame_rs_matches_reference(seq):
    k = 4
    H = seq.image_size[1]
    pts3d, uv = _frame_obs(seq, k)
    assert 40 <= pts3d.shape[0] <= 120
    rng = np.random.RandomState(0)
    uv = uv.copy()
    out = rng.rand(uv.shape[0]) < 0.1
    uv[out] = rng.rand(out.sum(), 2) * np.array(seq.image_size)
    intr = np.asarray(seq.params_gt.intr[0])
    prior = (np.asarray(seq.params_gt.q[k - 1]),
             np.asarray(seq.params_gt.c[k - 1]))
    *pj, sj = jregister(pts3d, uv, uv[:, 1], intr, seq.problem.model, *prior,
                        image_height=H, loss=JLoss("huber", 4.0), dtype=DT)
    tm = CameraModel(rolling_shutter=True, rotation_interp="nlerp",
                     use_distortion=False)
    *pt, st = register_frame(pts3d, uv, uv[:, 1], intr, tm, *prior,
                             image_height=H, loss=Loss("huber", 4.0),
                             dtype=torch.float64, device="cpu")
    assert st.termination == sj.termination == "CONVERGENCE"
    assert (st.linear_solver, st.evaluator) == ("dense_schur",
                                                "torch-flat+device_loop")
    for a, b in zip(pt, pj):
        _close_pose(a, b)
    assert st.final_rmse_inlier == pytest.approx(sj.final_rmse_inlier,
                                                 abs=1e-6)
    # the pose is the true one, 10% outliers notwithstanding
    assert abs(np.sum(N(pt[0]) * np.asarray(seq.params_gt.q[k]))) > 1 - 1e-5
    np.testing.assert_allclose(N(pt[1]), np.asarray(seq.params_gt.c[k]),
                               atol=1e-2)


def test_register_frame_gs_matches_reference():
    ba = jsyn.make_ba_problem(
        n_poses=6, n_points=150, track_len=4, rolling_shutter=False,
        use_distortion=True, pixel_noise=0.4, seed=9, dtype=DT, pad_to=32)
    k = 3
    pts3d, uv = _frame_obs(ba, k)
    intr = np.asarray(ba.params_gt.intr[0])
    q0 = np.asarray(jquat.boxplus(ba.params_gt.q[k],
                                  J([0.02, -0.01, 0.015])))
    c0 = np.asarray(ba.params_gt.c[k]) + 0.05
    *pj, sj = jregister(pts3d, uv, uv[:, 1], intr, ba.problem.model, q0, c0,
                        dtype=DT)
    *pt, st = register_frame(pts3d, uv, uv[:, 1], intr,
                             CameraModel(use_distortion=True), q0, c0,
                             dtype=torch.float64, device="cpu")
    assert st.termination == sj.termination == "CONVERGENCE"
    for a, b in zip(pt, pj):
        _close_pose(a, b)
    assert torch.equal(pt[0], pt[2]) and torch.equal(pt[1], pt[3])
    assert st.final_rmse_inlier == pytest.approx(sj.final_rmse_inlier,
                                                 abs=1e-6)


def test_pnp_rejects_degenerate_input():
    model = CameraModel(rolling_shutter=True)
    ident = np.array([1.0, 0, 0, 0])
    with pytest.raises(ValueError, match="correspondences"):
        register_frame(np.zeros((2, 3)), np.zeros((2, 2)), np.zeros(2),
                       np.ones(9), model, ident, np.zeros(3),
                       image_height=768, device="cpu")
    with pytest.raises(ValueError, match="image_height"):
        register_frame(np.zeros((10, 3)), np.zeros((10, 2)), np.zeros(10),
                       np.ones(9), model, ident, np.zeros(3), device="cpu")


# --- RANSAC -------------------------------------------------------------------

def test_ransac_pnp_40pct_outliers_matches_reference():
    jm, tm, intr, q, c, pts, uv = _scene(n_cams=1, n_pts=200, seed=5,
                                         distortion=True, noise=0.5)
    rng = np.random.RandomState(9)
    uv1 = uv[0].copy()
    out = rng.rand(uv1.shape[0]) < 0.4
    uv1[out] = rng.uniform(0, 640, size=(out.sum(), 2))
    kw = dict(n_hypotheses=256, inlier_threshold=4.0, seed=0)
    qj, cj, _, _, inj, infoj = jransac(pts, uv1, intr, jm, **kw)
    qt, ct, qb, cb, inl, info = ransac_pnp(pts, uv1, intr, tm, device="cpu",
                                           **kw)
    assert qt.dtype == torch.float64
    np.testing.assert_array_equal(inl, inj)
    assert info["num_inliers"] == infoj["num_inliers"] >= 0.9 * (~out).sum()
    assert info["best_inliers_prepolish"] == infoj["best_inliers_prepolish"]
    _close_pose(qt, qj)
    _close_pose(ct, cj)
    assert torch.equal(qt, qb) and torch.equal(ct, cb)
    assert (inl & out).sum() <= 0.05 * out.sum()
    assert abs(np.sum(N(qt) * q[0])) > 1 - 1e-5
    np.testing.assert_allclose(N(ct), c[0], atol=5e-3)
    # without the polish: the winning hypothesis itself
    q0, c0, _, _, in0, info0 = ransac_pnp(pts, uv1, intr, tm, device="cpu",
                                          refine=False, **kw)
    qj0, cj0, _, _, inj0, _ = jransac(pts, uv1, intr, jm, refine=False, **kw)
    np.testing.assert_array_equal(in0, inj0)
    _close_pose(q0, qj0, 1e-7)
    _close_pose(c0, cj0, 1e-7)
    assert info0["summary"] is None


def test_ransac_pnp_fails_cleanly_on_garbage():
    rng = np.random.RandomState(0)
    pts = rng.randn(50, 3)
    uv = rng.uniform(0, 640, (50, 2))
    intr = np.array([800.0, 800, 320, 240, 0, 0, 0, 0, 0])
    with pytest.raises(ValueError, match="RANSAC failed"):
        ransac_pnp(pts, uv, intr, CameraModel(), n_hypotheses=64,
                   inlier_threshold=2.0, min_inliers=25, seed=1,
                   device="cpu")
    with pytest.raises(ValueError, match="matches"):
        ransac_pnp(pts[:2], uv[:2], intr, CameraModel(), device="cpu")
