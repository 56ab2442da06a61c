"""The band PCG kernel's live passes at the HBM rate, from the band's
shapes.

A frozen copy of the program's ``utils/roofline.py::band_pcg_bound``: a
pass reads the P block rows of 6 × 6(2W−1), the P 6×6 inverses of the
diagonal blocks and four vectors of 6P (p, q, r, z) once each, all
charged at the memory rate of one NVIDIA H100 SXM, 3.35 TB/s
(``roofline.py``'s peak).  It is a share of that rate, not a least time:
where the rows stay in shared memory (config 4) they cross HBM once a
launch, and where they stream (config 5) a pass's 26.9 MB fits the 50 MB
L2, so neither plan is held to HBM on every pass.
"""
from __future__ import annotations

from .roofline import PEAK_BYTES_S


def bytes_per_pass(P: int, W: int, itemsize: int) -> int:
    return itemsize * P * (6 * 6 * (2 * W - 1) + 36 + 4 * 6)


def bound_s(P: int, W: int, itemsize: int, live_passes: int) -> float:
    """Seconds for ``live_passes`` passes' bytes at the HBM rate."""
    return live_passes * bytes_per_pass(P, W, itemsize) / PEAK_BYTES_S
