"""Solver configuration — counterpart of ``rsba_tpu/solver/options.py``
(parity with ``ceres::Solver::Options``), trimmed to the knobs the port
has.

``Summary.evaluator`` records what ran: "cuda" (the fused kernel) or
"torch" (its plain version) for the banded solver, "torch-flat" for the
flat engines and "torch-flat-dogleg" for dogleg, each with
"+device_loop" appended when the on-device loop drove the solve."""
from __future__ import annotations

import dataclasses

LINEAR_SOLVERS = ("auto", "dense", "dense_schur", "iterative_schur",
                  "banded_schur")
PRECONDITIONERS = ("jacobi", "schur_jacobi", "cluster_jacobi")
EVALUATORS = ("auto", "cuda", "torch")


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Solver knobs.

    Trust-region semantics follow Ceres's Levenberg-Marquardt strategy:
    damping λ = 1/μ with μ the trust-region radius, radius grown by
    1/max(1/3, 1−(2ρ−1)³) on accepted steps and halved-with-backoff on
    rejections.
    """
    # Outer loop: "lm", or "dogleg" (TRADITIONAL_DOGLEG; exact solvers
    # "dense" / "dense_schur" only, host loop only).
    trust_region_strategy: str = "lm"
    max_iterations: int = 50
    initial_radius: float = 1e4
    max_radius: float = 1e16
    min_radius: float = 1e-32
    min_relative_decrease: float = 1e-3
    function_tolerance: float = 1e-6
    gradient_tolerance: float = 1e-10
    parameter_tolerance: float = 1e-8
    max_invalid_steps: int = 5         # consecutive non-finite-step budget

    # Linear solver.  "auto" picks the banded window solver when the
    # problem's track structure admits it and the flat "iterative_schur"
    # otherwise; "banded_schur" requires the window layout.  "dense"
    # (normal equations + Cholesky; point-block elimination above a size
    # guard) and "dense_schur" are the exact flat engines.
    linear_solver: str = "auto"
    # PCG preconditioner of iterative_schur and the banded solver:
    # "schur_jacobi" (per-pose 6×6 blocks of S; "jacobi" aliases it on
    # the band and is the plain diagonal on iterative_schur), or
    # "cluster_jacobi": on the band contiguous 16-pose segments factored
    # dense, on iterative_schur co-visibility clusters of cameras with
    # per-cluster dense blocks of S (solver/cluster.py).
    preconditioner: str = "schur_jacobi"
    min_lm_diagonal: float = 1e-6
    max_lm_diagonal: float = 1e32
    jacobi_scaling: bool = True
    # PCG: max iterations and the forcing-sequence eta.
    max_cg_iterations: int = 100
    cg_eta: float = 1e-2
    # Iterative refinement sweeps after the dense Cholesky solves.
    refinement_steps: int = 1
    # Evaluator of the banded solver's prepare phase: "cuda" = the fused
    # evaluate+assemble CUDA kernel (raises on CPU tensors), "torch" = its
    # plain PyTorch version, "auto" = the kernel on CUDA tensors and the
    # plain version on CPU tensors.
    evaluator: str = "auto"
    # "highest": solve() turns TF32 off for matmuls and cuDNN.  TF32 /
    # bf16 accumulation in the normal equations cost 5% final cost and
    # 40 vs 6 LM iterations on the reference.
    matmul_precision: str = "highest"

    # On-device LM loop (solver/lm_device.py): one step attempt is one
    # function on tensors with every decision taken on the device.  On a
    # CUDA problem it is captured in a CUDA graph and replayed, and the
    # host reads one small tensor back per attempt; on a CPU problem the
    # same function runs eagerly.  "auto" = use it when the engine exposes
    # raw phase functions (every engine but dogleg does); "on" requires
    # it (raises otherwise); "off" = the host-driven loop.
    device_loop: str = "auto"
    # With a per-iteration callback installed, the device loop returns to
    # the caller every 4·device_block_iters attempts so that the callback
    # still fires.  0 = never (the callback then fires at the end).
    device_block_iters: int = 8

    # Runtime gradient verification (Ceres Solver::Options::check_gradients
    # / GradientChecker): before solving, compare the forward-mode block
    # Jacobians against central finite differences on a sample of
    # observations and raise on a mismatch.  Precision 0 = the dtype's
    # default in lm.solve (1e-5 in float64, 2e-3 in float32, where finite
    # differences floor at ~1e-3).
    check_gradients: bool = False
    gradient_check_relative_precision: float = 0.0

    # Reporting
    verbose: bool = False

    def __post_init__(self):
        if self.linear_solver not in LINEAR_SOLVERS:
            raise ValueError(
                f"linear_solver must be one of {LINEAR_SOLVERS}, "
                f"got {self.linear_solver!r}")
        if self.preconditioner not in PRECONDITIONERS:
            raise ValueError(
                f"preconditioner must be one of {PRECONDITIONERS}, "
                f"got {self.preconditioner!r}")
        if self.evaluator not in EVALUATORS:
            raise ValueError(
                f"evaluator must be one of {EVALUATORS}, "
                f"got {self.evaluator!r}")
        if self.trust_region_strategy not in ("lm", "dogleg"):
            raise ValueError(
                f"trust_region_strategy must be 'lm' or 'dogleg', "
                f"got {self.trust_region_strategy!r}")
        if self.device_loop not in ("auto", "on", "off"):
            raise ValueError(
                f"device_loop must be 'auto', 'on' or 'off', "
                f"got {self.device_loop!r}")
