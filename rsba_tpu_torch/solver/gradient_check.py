"""Runtime gradient checker — counterpart of
``rsba_tpu/solver/gradient_check.py`` (parity with
``ceres::GradientChecker`` / ``Solver::Options::check_gradients``).

Verifies the forward-mode block Jacobians of ``residuals.evaluate``
against central finite differences of the same tangent-space residual
function, on a deterministic sample of observations.  Enabled with
``SolverOptions(check_gradients=True)``: ``lm.solve`` runs the check on
the initial parameters and raises on a violation, as Ceres aborts the
solve with a gradient-check report.

The check exercises the flat evaluation path whatever engine solves; the
kernel is held to its plain version, and that to this path, by the tests.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..geometry import Loss
from ..problem.types import POSE_DOF, Params, Problem, problem_from_numpy
from . import residuals


def check_gradients(problem: Problem, params: Params,
                    relative_precision: float = 1e-5,
                    max_samples: int = 64,
                    step: float | None = None) -> dict:
    """Compare forward-mode and central-difference Jacobians on sampled
    observations.

    Returns {"max_relative_error", "n_checked", "worst_obs"}; raises
    ValueError when the worst relative error (with an absolute floor
    scaled to the Jacobian's magnitude) exceeds ``relative_precision``.

    The forward-mode Jacobian is taken in the problem's dtype: it is what
    the check checks.  The central differences always run in float64, on
    a float64 twin of the sampled problem and parameters, as Ceres's
    GradientChecker differences in double: in float32 they would carry
    the projections' round-off over the step (about 1e-2 of the Jacobian
    on config 1), and the check could not tell a correct float32
    Jacobian from a wrong one.  ``step`` defaults to float64's
    eps**(1/3), the central-difference optimum.  The sample is drawn with
    ``np.random.RandomState(0)``.
    """
    obs = problem.obs
    valid = np.nonzero(obs.mask.detach().cpu().numpy() > 0)[0]
    if valid.size == 0:
        return {"max_relative_error": 0.0, "n_checked": 0, "worst_obs": -1}
    rng = np.random.RandomState(0)
    sel = np.sort(rng.choice(valid, size=min(max_samples, valid.size),
                             replace=False))
    sel_t = torch.as_tensor(sel, device=problem.device)
    sub = dataclasses.replace(obs, **{
        f.name: getattr(obs, f.name)[sel_t]
        for f in dataclasses.fields(obs)})

    f64 = torch.float64
    h = (float(torch.finfo(f64).eps) ** (1.0 / 3.0) if step is None
         else step)

    # Uncorrected Jacobians: a trivial-loss view of the sampled problem
    # (the Triggs correction is a transformation tested on its own).
    plain = problem.replace(obs=sub, loss=Loss())
    ev = residuals.evaluate(params, plain)
    ni = plain.intr_tangent_dim
    J_ad = torch.cat([ev.J_pose[:, :, 0, :], ev.J_pose[:, :, 1, :],
                      ev.J_intr, ev.J_pt], dim=-1)           # (n, 2, 15+ni)

    if params.dtype != f64:
        plain = problem_from_numpy(plain, device=problem.device, dtype=f64)
        params = params.astype(f64)
        sub = plain.obs
    f = residuals.gathered_residual_fn(plain)
    dim = 2 * POSE_DOF + ni + 3
    eye = torch.eye(dim, dtype=f64, device=problem.device) * h

    def res_at(d, *gathered):
        d_pa, d_pb, d_i, d_pt = torch.split(d, [POSE_DOF, POSE_DOF, ni, 3])
        return f(d_pa, d_pb, d_i, d_pt, *gathered)

    def fd_one(*gathered):
        plus = torch.func.vmap(lambda d: res_at(d, *gathered))(eye)
        minus = torch.func.vmap(lambda d: res_at(-d, *gathered))(eye)
        return ((plus - minus) / (2.0 * h)).T                # (2, dim)

    J_fd = torch.func.vmap(fd_one)(*residuals._gather(params, sub), sub.uv,
                                   sub.t)
    # Constant blocks: the forward-mode Jacobian has the free masks applied.
    rep = lambda free, idx, w: free[idx.long()][:, None].expand(-1, w)  # noqa: E731
    col_mask = torch.cat([
        rep(problem.pose_free, sub.pose_a, POSE_DOF),
        rep(problem.pose_free, sub.pose_b, POSE_DOF),
        rep(problem.intr_free, sub.intr_idx, ni),
        rep(problem.point_free, sub.point, 3)], dim=1)
    J_fd = J_fd * col_mask[:, None, :]

    J_ad = J_ad.detach().cpu().numpy().astype(np.float64)
    J_fd = J_fd.detach().cpu().numpy().astype(np.float64)
    scale = np.maximum(np.abs(J_ad), np.abs(J_fd))
    floor = max(1e-3 * scale.max(), 1e-12)
    rel = np.abs(J_ad - J_fd) / np.maximum(scale, floor)
    worst = int(np.argmax(rel.max(axis=(1, 2))))
    report = {"max_relative_error": float(rel.max()),
              "n_checked": int(sel.size), "worst_obs": int(sel[worst])}
    if report["max_relative_error"] > relative_precision:
        raise ValueError(
            f"gradient check FAILED: max relative error "
            f"{report['max_relative_error']:.3e} > {relative_precision:g} "
            f"at observation {report['worst_obs']} "
            f"(forward mode vs central differences, h={h:.2e}, "
            f"{report['n_checked']} observations sampled)")
    return report
