"""Sharded bundle adjustment over ranks of ``torch.distributed``.

Counterpart of ``rsba_tpu/dist``.  Observations are split across ranks,
by window rows for the banded solver (``make_sharded_window_solver_fns``)
and by landmark ownership for the flat ones (``repartition_by_point`` +
``make_sharded_solver_fns``); poses are whole on every rank, and the
camera-side reductions are all-reduced.  One process per rank: the card
and NCCL by default, gloo on the CPU; ``dist.launch.spawn`` starts the
ranks of a world on one host, ``initialize_multihost`` joins this
process to a world across hosts.
"""
import dataclasses

from .banded_sharded import make_sharded_window_solver_fns
from .mesh import AXIS, Mesh, initialize_multihost, make_mesh, shard_ba
from .partition import PartitionInfo, repartition_by_point
from .sharded import make_sharded_solver_fns

__all__ = [
    "AXIS", "Mesh", "initialize_multihost", "make_mesh", "shard_ba",
    "PartitionInfo", "repartition_by_point", "make_sharded_solver_fns",
    "make_sharded_window_solver_fns", "make_solver_fns",
]


def make_solver_fns(problem, params0, options, mesh, say=None):
    """The sharded engine for ``options`` over ``mesh``, as the CLI picks
    it: the banded window solver split by rows when
    ``options.linear_solver`` is auto or banded_schur and the problem
    admits the window layout (banded_schur without it raises), else the
    flat landmark-sharded solver on the repartitioned problem
    (``dense_schur`` when asked, else ``iterative_schur``).  ``say`` gets
    the reason of a fallback.

    Returns (fns, problem, params0, options, info): the problem and
    initial parameters the engine solves (repartitioned on the flat
    path), the options (naming the flat solver on the flat path), and
    the flat path's ``PartitionInfo`` (None on the banded one).
    """
    if options.linear_solver in ("auto", "banded_schur"):
        try:
            fns = make_sharded_window_solver_fns(problem, options, mesh)
            return fns, problem, params0, options, None
        except ValueError as e:
            if options.linear_solver == "banded_schur":
                raise
            if say is not None:
                say(f"window layout unavailable ({e}); using the flat "
                    "sharded solver")
    flat = ("dense_schur" if options.linear_solver == "dense_schur"
            else "iterative_schur")
    options = dataclasses.replace(options, linear_solver=flat)
    problem, params0, info = repartition_by_point(problem, params0,
                                                  n_shards=mesh.size)
    fns = make_sharded_solver_fns(problem, options, mesh)
    return fns, problem, params0, options, info
