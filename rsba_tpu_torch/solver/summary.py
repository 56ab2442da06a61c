"""Solve diagnostics — counterpart of ``rsba_tpu/solver/summary.py``
(parity with ``ceres::Solver::Summary`` / ``IterationSummary``):
per-iteration cost, gradient norm, step quality, trust-region radius,
timings; final termination reason; ``full_report()``."""
from __future__ import annotations

import dataclasses
import json
from typing import List

TERMINATIONS = (
    "CONVERGENCE", "NO_CONVERGENCE", "FAILURE", "USER_SUCCESS",
)


@dataclasses.dataclass
class IterationSummary:
    iteration: int
    cost: float
    cost_change: float
    gradient_max_norm: float
    step_norm: float
    relative_decrease: float
    trust_region_radius: float
    accepted: bool
    linear_solver_iterations: int = 0
    wall_time: float = 0.0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


@dataclasses.dataclass
class Summary:
    initial_cost: float = 0.0
    final_cost: float = 0.0
    initial_rmse: float = 0.0
    final_rmse: float = 0.0
    # RMSE over inlier observations (‖r‖ ≤ 3× robust-loss scale); equals
    # the plain RMSE for non-robust problems.
    initial_rmse_inlier: float = 0.0
    final_rmse_inlier: float = 0.0
    iterations: List[IterationSummary] = dataclasses.field(default_factory=list)
    termination: str = "NO_CONVERGENCE"
    message: str = ""
    num_residuals: int = 0
    num_parameters_tangent: int = 0
    num_successful_steps: int = 0
    num_unsuccessful_steps: int = 0
    # Wall-clock phase breakdown (seconds), host clock around work that
    # ends in a device synchronisation.
    preprocessing_time: float = 0.0
    evaluation_time: float = 0.0
    linear_solver_time: float = 0.0
    total_time: float = 0.0
    # Tensors the on-device loop read back to the host (one per attempt
    # and one per block); 0 under the host loop, which reads scalars.
    host_reads: int = 0
    # Resolved engine pair (what actually ran, not the requested string):
    # e.g. ("banded_schur", "cuda+device_loop") or ("dense", "torch-flat").
    linear_solver: str = ""
    evaluator: str = ""

    @property
    def num_iterations(self) -> int:
        return len(self.iterations)

    def brief_report(self) -> str:
        return (f"rsba_tpu_torch solver: cost {self.initial_cost:.6e} -> "
                f"{self.final_cost:.6e}, rmse {self.initial_rmse:.4f} -> "
                f"{self.final_rmse:.4f} px, "
                f"{self.num_successful_steps} accepted / "
                f"{self.num_unsuccessful_steps} rejected steps, "
                f"{self.termination} ({self.message}), "
                f"{self.total_time:.3f}s")

    def full_report(self) -> str:
        lines = [
            "rsba_tpu_torch Solver Report",
            "----------------------------",
            f"Residuals            : {self.num_residuals}",
            f"Tangent parameters   : {self.num_parameters_tangent}",
            f"Linear solver        : {self.linear_solver}"
            + (f" (evaluator: {self.evaluator})" if self.evaluator else ""),
            f"Initial cost         : {self.initial_cost:.12e}",
            f"Final cost           : {self.final_cost:.12e}",
            f"Initial RMSE (px)    : {self.initial_rmse:.6f}",
            f"Final RMSE (px)      : {self.final_rmse:.6f}",
            f"Final inlier RMSE    : {self.final_rmse_inlier:.6f}",
            f"Termination          : {self.termination} ({self.message})",
            "",
            " iter      cost     cost_change   |grad|_max   |step|  "
            "  rel_dec     radius  ok  time(s)",
        ]
        for it in self.iterations:
            lines.append(
                f"{it.iteration:5d} {it.cost:12.6e} {it.cost_change:12.4e} "
                f"{it.gradient_max_norm:11.4e} {it.step_norm:9.3e} "
                f"{it.relative_decrease:9.2e} {it.trust_region_radius:9.3e} "
                f"{'  y' if it.accepted else '  n'} {it.wall_time:8.4f}")
        lines += [
            "",
            f"Successful steps     : {self.num_successful_steps}",
            f"Unsuccessful steps   : {self.num_unsuccessful_steps}",
            f"Preprocessing time   : {self.preprocessing_time:.4f}s",
            f"Evaluation time      : {self.evaluation_time:.4f}s",
            f"Linear solver time   : {self.linear_solver_time:.4f}s",
            f"Total time           : {self.total_time:.4f}s",
        ]
        return "\n".join(lines)

    def write_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for it in self.iterations:
                f.write(it.to_json() + "\n")
