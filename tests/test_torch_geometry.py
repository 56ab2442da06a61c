"""Geometry parity: rsba_tpu_torch.geometry vs rsba_tpu.geometry (f64).

The same inputs, made with numpy from a seed, go through the JAX
reference and the PyTorch port; outputs agree to rtol 1e-12.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsba_tpu.geometry import camera as jcam
from rsba_tpu.geometry import distortion as jdist
from rsba_tpu.geometry import interpolate as jinterp
from rsba_tpu.geometry import losses as jloss
from rsba_tpu.geometry import quaternion as jq
from rsba_tpu_torch.geometry import camera as tcam
from rsba_tpu_torch.geometry import distortion as tdist
from rsba_tpu_torch.geometry import interpolate as tinterp
from rsba_tpu_torch.geometry import losses as tloss
from rsba_tpu_torch.geometry import quaternion as tq

RTOL = 1e-12
N = 64


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(N, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q2 = q + 0.05 * rng.randn(N, 4)          # nearby keyframe pose
    q2 /= np.linalg.norm(q2, axis=1, keepdims=True)
    q2[:4] = q[:4]                           # qa == qb (0/0 guard)
    aa = rng.randn(N, 3) * 0.5
    aa[:8] *= 1e-6                           # Taylor branch
    aa[8:10] = 0.0
    return {
        "q": q, "q2": q2, "aa": aa, "aa2": rng.randn(N, 3) * 0.5,
        "v": rng.randn(N, 3), "t": rng.rand(N),
        "c": rng.randn(N, 3) * 0.1, "c2": rng.randn(N, 3) * 0.1,
        "X": rng.randn(N, 3) * 0.3 + np.array([0.0, 0.0, 3.0]),
        "xy": rng.randn(N, 2) * 0.3,
        "coeffs": np.array([-0.15, 0.03, 1e-3, -2e-3, 1e-4]),
        "intr": np.array([900.0, 905.0, 512.0, 384.0, -0.15, 0.03, 1e-3,
                          -2e-3, 1e-4]),
        "r": rng.randn(N, 2) * 5.0, "J": rng.randn(N, 2, 15),
    }


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.as_tensor(x, dtype=torch.float64)


# name → (jax fn, torch fn, input keys)
CASES = {
    "normalize": (jq.normalize, tq.normalize, ("q2",)),
    "multiply": (jq.multiply, tq.multiply, ("q", "q2")),
    "conjugate": (jq.conjugate, tq.conjugate, ("q",)),
    "rotate": (jq.rotate, tq.rotate, ("q", "v")),
    "from_axis_angle": (jq.from_axis_angle, tq.from_axis_angle, ("aa",)),
    "to_axis_angle": (jq.to_axis_angle, tq.to_axis_angle, ("q",)),
    "boxplus": (jq.boxplus, tq.boxplus, ("q", "aa")),
    "relative": (jq.relative, tq.relative, ("q", "q2")),
    "slerp": (jq.slerp, tq.slerp, ("q", "q2", "t")),
    "nlerp": (jq.nlerp, tq.nlerp, ("q", "q2", "t")),
    "lerp_axis_angle": (jq.lerp_axis_angle, tq.lerp_axis_angle,
                        ("aa", "aa2", "t")),
    "distort": (jdist.distort, tdist.distort, ("xy", "coeffs")),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_function_matches_reference(name):
    jf, tf, keys = CASES[name]
    d = _inputs()
    want = np.asarray(jf(*(_j(d[k]) for k in keys)))
    got = tf(*(_t(d[k]) for k in keys)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-15)


@pytest.mark.parametrize("mode", ["slerp", "nlerp", "lerp_aa"])
def test_interpolate_pose_matches_reference(mode):
    d = _inputs(1)
    args = ("q", "c", "q2", "c2", "t")
    jq_, jc = jinterp.interpolate_pose(*(_j(d[k]) for k in args), mode)
    tq_, tc = tinterp.interpolate_pose(*(_t(d[k]) for k in args), mode)
    np.testing.assert_allclose(tq_.numpy(), np.asarray(jq_), rtol=RTOL,
                               atol=1e-15)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=RTOL,
                               atol=1e-15)


@pytest.mark.parametrize("rs,mode,dist,sign", [
    (False, "slerp", False, 1.0), (False, "slerp", True, -1.0),
    (True, "slerp", True, 1.0), (True, "nlerp", False, 1.0),
    (True, "lerp_aa", True, 1.0)])
def test_project_and_depth_match_reference(rs, mode, dist, sign):
    d = _inputs(2)
    jm = jcam.CameraModel(rolling_shutter=rs, rotation_interp=mode,
                          use_distortion=dist, projection_sign=sign)
    tm = tcam.CameraModel(rolling_shutter=rs, rotation_interp=mode,
                          use_distortion=dist, projection_sign=sign)
    X = d["X"] * sign
    jargs = (_j(d["q"]), _j(d["c"]), _j(d["q2"]), _j(d["c2"]))
    targs = (_t(d["q"]), _t(d["c"]), _t(d["q2"]), _t(d["c2"]))
    want = jcam.project(*jargs, _j(d["intr"]), _j(X), _j(d["t"]), jm)
    got = tcam.project(*targs, _t(d["intr"]), _t(X), _t(d["t"]), tm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    want = jcam.depth_in_camera(*jargs, _j(X), _j(d["t"]), jm)
    got = tcam.depth_in_camera(*targs, _t(X), _t(d["t"]), tm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


@pytest.mark.parametrize("kind", ["trivial", "huber", "soft_l1", "cauchy"])
def test_loss_evaluate_and_correct_match_reference(kind):
    d = _inputs(3)
    jl, tl = jloss.Loss(kind, 4.0), tloss.Loss(kind, 4.0)
    s = np.sum(d["r"] ** 2, axis=1)
    for w, g in zip(jl.evaluate(_j(s)), tl.evaluate(_t(s))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)
    for w, g in zip(jl.correct(_j(d["r"]), _j(d["J"])),
                    tl.correct(_t(d["r"]), _t(d["J"]))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=1e-14)


def test_jacfwd_keeps_working_dtype():
    """Forward-mode tangents through the projection stay float32."""
    tm = tcam.CameraModel(rolling_shutter=True, use_distortion=True)
    d = _inputs(4)
    f32 = lambda k: torch.as_tensor(d[k][0], dtype=torch.float32)  # noqa
    intr = torch.as_tensor(d["intr"], dtype=torch.float32)
    J = torch.func.jacfwd(
        lambda X: tcam.project(f32("q"), f32("c"), f32("q2"), f32("c2"),
                               intr, X, f32("t"), tm))(f32("X"))
    assert J.dtype == torch.float32 and torch.isfinite(J).all()
