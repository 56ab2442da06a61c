"""The flat ``iterative_schur`` PCG's live passes at the HBM rate, from
the problem's sizes.

A global-shutter problem's pass of ``solver/pcg.py``'s PCG applies the
matrix-free reduced camera system and the Schur-Jacobi preconditioner
once, and at least reads each operand once: the pose_a half of J_pose
(N, 2, 6), J_intr (N, 2, ni), J_pt (N, 2, 3), the int32 pose_a, intr_idx
and point of each observation, C_λ⁻¹ (M, 3, 3), the preconditioner's
factors (P 6×6 and K ni×ni), five camera vectors of Dc = 6P + K·ni and
one point vector of 3M, all charged at the memory rate of one NVIDIA
H100 SXM, 3.35 TB/s (``roofline.py``'s peak).  Its operations, about one
FLOP a byte, take far less time at the float32 rate, so the bound is the
bytes'.  Passes that the program's unrolled loop makes after CG has
converged are frozen: they count as time, not as work.
"""
from __future__ import annotations

from .roofline import PEAK_BYTES_S


def bytes_per_pass(N: int, M: int, P: int, K: int, itemsize: int,
                   ni: int = 3) -> int:
    dc = 6 * P + K * ni
    return (itemsize * N * 2 * (6 + ni + 3) + 4 * N * 3
            + itemsize * (9 * M + 36 * P + ni * ni * K + 5 * dc + 3 * M))


def bound_s(N: int, M: int, P: int, K: int, itemsize: int,
            live_passes: int, ni: int = 3) -> float:
    """Seconds for ``live_passes`` passes' bytes at the HBM rate."""
    return live_passes * bytes_per_pass(N, M, P, K, itemsize, ni) \
        / PEAK_BYTES_S
