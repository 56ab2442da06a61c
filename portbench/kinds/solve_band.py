"""Traffic kind ``solve_band``: the ``solve`` kind (``kinds/solve.py``)
on problems too large for its dense float64 reference, whose camera
system is a block band.

Set-up, the measured window and release are the ``solve`` kind's, run as
they are: the pool made on the device from the generator's seeds, one
warm-up solve, each request a new ``Problem`` and ``Params`` copied to
the card and solved by ``rsba_tpu_torch.solver.solve`` with no ``fns``,
the reservoir of checked solves and the traced slice.  The reference
that the ``solve`` kind reaches through its module name ``lsq`` is bound
to ``reference/lsq_band.py`` while set-up, the window and the check run:
the same data, cost and statistics, and a Gauss-Newton step whose
reduced camera system is a block band, so that no dense (6P, 6P) matrix
is formed.  That reference decides ``correct`` as the ``solve`` kind's
does (``gn_gain``, ``cost_gap``, ``rmse_gap``, ``failed``), and the
control (``--control bf16``) is its ``optimum`` in bfloat16.
"""
from __future__ import annotations

import contextlib

from ..reference import lsq_band
from . import solve
from .solve import State, release  # noqa: F401


@contextlib.contextmanager
def _band_reference():
    dense = solve.lsq
    solve.lsq = lsq_band
    try:
        yield
    finally:
        solve.lsq = dense


def setup(cfg: dict, traffic: dict, seed: int, device, control: str) -> State:
    with _band_reference():
        return solve.setup(cfg, traffic, seed, device, control)


def window(st: State, seconds: float, run, tracer) -> None:
    with _band_reference():
        solve.window(st, seconds, run, tracer)


def check(st: State, run, limits: dict, device) -> list:
    """(name, value, limit) of each number compared (the ``solve`` kind's,
    against ``lsq_band``)."""
    with _band_reference():
        return solve.check(st, run, limits, device)
