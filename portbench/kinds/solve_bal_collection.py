"""Traffic kind ``solve_bal_collection``: the ``solve_bal`` kind
(``kinds/solve_bal.py``) on photo collections too large for its reference
(``reference/generator_bal_collection.py``), where ``linear_solver``
"auto" resolves to the matrix-free ``iterative_schur``.

Set-up and the measured window are the ``solve_bal`` kind's, run as they
are: the pool made from the generator's seeds, a set-up solve of every
pool problem so that the program's engine cache holds each one's engine
and graphs, each request a new ``Problem`` and ``Params`` copied to the
card and solved by ``rsba_tpu_torch.solver.solve`` with no ``fns``, the
reservoir of checked solves and the traced slice.  In a traced run the
problems of the traced slice are solved once more before the window,
under a profiler of the host alone, so that the cache also holds their
traced engines (it keys on tracing) and the slice times the cached path
that the window runs; their spans are dropped.  A window that ends
before the slice has all its solves (one solve outlasting the window)
still closes the profiler, so that the slice's trace is read.  The
generator and the reference that the ``solve_bal`` kind reaches through
its module names ``generator_bal`` and ``lsq_bal`` are bound to
``generator_bal_collection`` and ``lsq_bal_collection`` while set-up, the
window and the check run.  Release also empties the program's engine
cache before the check.  The reference has ``lsq_bal``'s data, cost,
statistics and Gauss-Newton gain, with its reduced camera system formed
point group by point group, and decides ``correct`` as the ``solve_bal``
kind's does (``gn_gain``, ``cost_gap``, ``rmse_gap``, ``failed``); the
control (``--control bf16``) is its ``optimum`` in bfloat16.

The ``solve_bal`` kind prices each profiled ``reduced_system`` span at
``dense_schur``'s bound; this kind's engine is not ``dense_schur``, so
that count is left out.  The flat PCG's roofline is read from the
program's spans (``metrics/flat_pcg_roofline.py``).
"""
from __future__ import annotations

import contextlib

from ..reference import generator_bal_collection, lsq_bal_collection
from . import solve, solve_bal
from .solve import State


def _no_slice_counters(st: State, run) -> None:
    """No dense Schur bound: this engine forms no dense S."""


@contextlib.contextmanager
def _collection():
    saved = (solve_bal.generator_bal, solve_bal.lsq_bal,
             solve_bal._slice_counters)
    solve_bal.generator_bal = generator_bal_collection
    solve_bal.lsq_bal = lsq_bal_collection
    solve_bal._slice_counters = _no_slice_counters
    try:
        yield
    finally:
        (solve_bal.generator_bal, solve_bal.lsq_bal,
         solve_bal._slice_counters) = saved


def setup(cfg: dict, traffic: dict, seed: int, device, control: str) -> State:
    with _collection():
        return solve_bal.setup(cfg, traffic, seed, device, control)


def _warm_traced(st: State) -> None:
    """The traced slice's problems solved once with tracing on, their
    spans dropped: the engine cache then holds their traced engines."""
    from torch.profiler import ProfilerActivity, profile

    from rsba_tpu_torch.solver import lm
    from rsba_tpu_torch.utils import trace
    n = min(st.traffic.get("trace_solves", 2), len(st.host))
    with profile(activities=[ProfilerActivity.CPU]):
        for h in st.host[:n]:
            lm.solve(*solve_bal._program_inputs(h, st.device), st.options)
        solve._sync(st.device)
    trace.clear()


def window(st: State, seconds: float, run, tracer) -> None:
    if tracer.enabled and st.control is None:
        _warm_traced(st)
    with _collection():
        solve_bal.window(st, seconds, run, tracer)
    tracer.stop()


def release(st: State) -> None:
    """The ``solve`` kind's release, and the program's cached engines,
    which the check's float64 reference needs the room of."""
    from rsba_tpu_torch.solver import lm_device
    solve.release(st)
    lm_device.engines.clear()


def check(st: State, run, limits: dict, device) -> list:
    """(name, value, limit) of each number compared (the ``solve_bal``
    kind's, against ``lsq_bal_collection``)."""
    with _collection():
        return solve_bal.check(st, run, limits, device)
