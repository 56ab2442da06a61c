"""On-device Levenberg–Marquardt loop.

Counterpart of ``rsba_tpu/solver/lm_device.py``: the same trust-region
semantics as the host loop (``lm.solve``), with every decision of a
step attempt taken on the device.  One attempt is one function on
tensors (``_Runner._attempt``): solve_step → apply_step → cost decrease →
valid / accept → radius update → termination tests → record, each
decision a ``torch.where``, the new parameters, ρ and scalars selected
into static tensors that are updated in place.  A re-prepare after an
accepted or an invalid step is a second function (``_Runner._refresh``).

On a CUDA problem the two functions are captured once in CUDA graphs and
replayed; on a CPU problem the same functions run eagerly.  Either way
the host reads one small tensor back per attempt (the termination code
and the re-prepare flag), and the record table once per block.  If the
capture or a replay fails the solve raises: there is no other route on a
CUDA problem.

A flat engine and its runner outlive their solve (``engines``, an
``_EngineCache``): a later ``lm.solve`` with no ``fns`` on a problem of
the same structure copies its data into the tensors the graphs read and
replays them, with nothing planned or captured again.

Loop structure (one attempt matches the host loop's inner retry loop
flattened):

* entry invariant: ``aux`` (the prepare output) is valid for the current
  ``params``; an attempt whose entry finds a termination code set changes
  nothing;
* invalid steps (non-finite dx or non-positive predicted decrease)
  shrink the radius and force a re-prepare, as the host loop's
  break-to-outer does;
* accepted steps update params and re-prepare; rejected valid steps
  reuse ``aux``;
* a block's entry prepare is un-charged on re-entry (``charge=False``):
  it recomputes the aux that the previous block already charged.

Termination codes:
  1 gradient tolerance   2 non-finite cost        3 invalid-step budget
  4 function tolerance   5 parameter tolerance    6 stagnant rejection
  7 radius below minimum 8 max iterations         0 still running
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import time

import torch

from ..problem.types import Params, Problem
from ..utils import trace
from .options import SolverOptions
from .summary import IterationSummary, Summary

TERM_RUNNING = 0
TERM_GRADIENT = 1
TERM_FAIL_COST = 2
TERM_FAIL_INVALID = 3
TERM_FTOL = 4
TERM_PTOL = 5
TERM_FTOL_STAGNANT = 6
TERM_RADIUS = 7
TERM_MAX_ITERATIONS = 8

_TERMINATIONS = {
    TERM_GRADIENT: ("CONVERGENCE", "gradient tolerance reached"),
    TERM_FAIL_COST: ("FAILURE", "non-finite cost"),
    TERM_FAIL_INVALID: ("FAILURE", "too many consecutive invalid steps"),
    TERM_FTOL: ("CONVERGENCE", "function tolerance reached"),
    TERM_PTOL: ("CONVERGENCE", "parameter tolerance reached"),
    TERM_FTOL_STAGNANT: ("CONVERGENCE",
                         "function tolerance reached (stagnant rejected "
                         "step)"),
    TERM_RADIUS: ("CONVERGENCE", "trust region radius below minimum"),
    TERM_MAX_ITERATIONS: ("NO_CONVERGENCE", "max iterations reached"),
}

#: record columns: cost, cost_change, gmax, step_norm, rho, radius,
#: accepted, linear-solver iterations
N_REC = 8

@dataclasses.dataclass
class _LoopState:
    """The loop's state: static tensors, updated in place."""
    params: Params            # engine-internal parameters
    aux: object               # prepare output (a tree of tensors)
    rho_ref: object           # per-slot robust costs of params (engines
    #                           with "cost_decrease_pair"), else None
    cost: torch.Tensor        # current (accepted) cost
    gmax: torch.Tensor        # gradient max-norm at the last prepare
    radius: torch.Tensor
    df: torch.Tensor          # decrease factor (rejection back-off)
    inv: torch.Tensor         # consecutive invalid steps (int32)
    n_outer: torch.Tensor     # prepares charged so far (int32)
    n_rec: torch.Tensor       # records written this block (int32)
    term: torch.Tensor        # termination code (int32)
    records: torch.Tensor     # (block_attempts, N_REC)
    run_prep: torch.Tensor    # the last attempt asks for a prepare (bool)
    flags: torch.Tensor       # (2,) int32: term, run_prep, for the host
    cost0: torch.Tensor       # cost at the block's entry


def _leaves(tree) -> list:
    """The tensors of a tree of dicts, tuples, lists and dataclasses, in
    a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree)
                for x in _leaves(getattr(tree, f.name))]
    raise TypeError(f"cannot walk {type(tree).__name__}")


def _tree_map(fn, tree):
    """A tree of the same structure with ``fn`` applied to each tensor."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    raise TypeError(f"cannot walk {type(tree).__name__}")


def _select_into(cond: torch.Tensor, new, static) -> None:
    """static ← where(cond, new, static), leaf by leaf, in place (one
    pass a leaf: ``where`` writes into ``static`` itself)."""
    for dst, src in zip(_leaves(static), _leaves(new)):
        torch.where(cond, src, dst, out=dst)


def _tree_finite(tree) -> torch.Tensor:
    """Whether every entry of the tree's tensors is finite (0-dim bool):
    x·0 is 0 for a finite x and NaN for ±inf or NaN, and a sum of zeros
    is exactly 0, so two launches a leaf say what ``isfinite().all()``
    says in four."""
    total = None
    for leaf in _leaves(tree):
        z = (leaf * 0).sum()
        total = z if total is None else total + z
    return total == 0


def _kernel_counters() -> tuple:
    """The wrappers of the package's CUDA kernels, whose ``launches`` a
    graph replay adds to."""
    from ..kernels import band_pcg, fused
    return (fused.fused_evaluate_assemble_cuda, band_pcg.band_pcg_cuda,
            fused.residual_pass_cuda)


class _Runner:
    """One engine's loop: its static state, the attempt and re-prepare
    functions over it, and (on CUDA) their graphs.

    ``raw`` holds the phase closures, each taking the engine's ``bound``
    payload as first argument:

      prepare(bound, params) -> aux           (contains "cost",
                                               "gradient_max_norm")
      solve_step(bound, aux, radius) -> (dx, predicted, lin_iters)
      apply_step(bound, params, dx) -> (cand, step_norm, x_norm)
      cost_decrease(bound, p_old, p_new) -> scalar
      rho_slots(bound, params) -> ρ                       (optional pair)
      cost_decrease_pair(bound, ρ_ref, cand) -> (scalar, ρ_new)

    The re-prepare is a graph of its own, which the host launches when
    the attempt's flag asks for it.

    Device spans (``utils/trace.py``), while tracing is on at capture
    and at replay: ``attempt`` (the attempt's graph and the re-prepare it
    asked for), and inside it ``solve_step`` (with the engine's own),
    ``residual_pass`` (retraction and cost decrease) and ``prepare``.
    Each replay's spans are read at the next read-back of ``flags`` or of
    the block's result, which follows the replay on the stream anyway.

    The two graphs share one memory pool, ``pool`` where given (the
    runners of ``engines`` all share one).  Graphs of one pool may replay
    in any order because no tensor allocated inside a capture outlives
    it: both functions copy what they compute into the state, which is
    allocated before the warm-up, outside the pool.
    """

    #: seconds the graph captures of all runners of the process took,
    #: warm-up included (the ``loop.capture`` spans' seconds); read by the
    #: tools that report what a workload of many solves costs
    capture_seconds = 0.0

    def __init__(self, raw: dict, options: SolverOptions,
                 block_attempts: int, pool=None):
        self.raw = raw
        self.options = options
        self.block_attempts = block_attempts
        self.pair = "cost_decrease_pair" in raw
        #: the graph memory pool to capture into (None: a pool of its own)
        self.pool = pool
        self.state = None
        self.graphs = None          # (attempt, refresh) on CUDA
        #: launches of each of ``_kernel_counters()`` in each graph
        self.kernel_nodes = ((), ())
        #: tensors read back to the host, and prepares run (block entries,
        #: re-prepares, the warm-up's), so far
        self.host_reads = 0
        self.prepares = 0
        #: the device spans' event pairs captured into each graph, the
        #: last attempt's device record and host span while its
        #: re-prepare's spans are unread, and device seconds by span name
        self.spans = ([], [])
        self._unread = None
        self.device_seconds = {}

    # --- the two captured functions -------------------------------------

    def _prep_checks(self, aux, charge):
        cost, gmax = aux["cost"], aux["gradient_max_norm"]
        term = torch.zeros((), dtype=torch.int32, device=cost.device)
        term = torch.where(charge & ~torch.isfinite(cost), TERM_FAIL_COST,
                           term)
        term = torch.where(
            (term == TERM_RUNNING) & charge
            & (gmax <= self.options.gradient_tolerance),
            TERM_GRADIENT, term)
        return cost, gmax, term

    def _attempt(self) -> None:
        s, raw, o = self.state, self.raw, self.options
        bound = raw["bound"]
        dtype = s.cost.dtype
        ftol, ptol = o.function_tolerance, o.parameter_tolerance
        live = s.term == TERM_RUNNING

        with trace.device_span("solve_step"):
            dx, predicted, li = raw["solve_step"](bound, s.aux, s.radius)
        with trace.device_span("residual_pass"):
            cand, step_norm, x_norm = raw["apply_step"](bound, s.params,
                                                        dx)
            # Pairwise cost decrease from one residual pass on the
            # candidate: ρ_ref (the current parameters' per-slot costs,
            # same evaluator) is carried in the state and replaced by an
            # accepted candidate's.
            if self.pair:
                decrease, rho_new = raw["cost_decrease_pair"](
                    bound, s.rho_ref, cand)
            else:
                decrease = raw["cost_decrease"](bound, s.params, cand)

        valid = (_tree_finite(dx) & (predicted > 0)
                 & torch.isfinite(predicted))
        new_cost = s.cost - decrease
        rho = torch.where(valid, decrease / predicted, 0.0)
        accept = valid & torch.isfinite(new_cost) & (
            rho > o.min_relative_decrease)

        # Radius update (Ceres LM rules).
        grow = s.radius / torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3,
                                      min=1.0 / 3.0)
        radius = torch.where(accept, torch.clamp(grow, max=o.max_radius),
                             s.radius / s.df)
        df = torch.where(accept, 2.0, s.df * 2.0)
        inv = torch.where(valid, 0, s.inv + 1)

        # Termination: the first code whose condition holds, where the
        # loop is still running.
        reject = ~accept
        small = (s.cost - new_cost).abs() <= ftol * s.cost
        stagnant = valid & reject & (predicted <= ftol * s.cost) & small
        first = torch.where(reject & (radius < o.min_radius), TERM_RADIUS,
                            s.term)
        first = torch.where(accept & (step_norm <= ptol * (x_norm + ptol)),
                            TERM_PTOL, first)
        first = torch.where(accept & small, TERM_FTOL, first)
        first = torch.where(stagnant, TERM_FTOL_STAGNANT, first)
        first = torch.where(~valid & (inv > o.max_invalid_steps),
                            TERM_FAIL_INVALID, first)
        term = torch.where(live, first, s.term)

        # Record (valid attempts only, as the host loop writes them).
        rec = torch.stack([
            torch.where(accept, new_cost, s.cost).to(dtype),
            (s.cost - new_cost).to(dtype), s.gmax.to(dtype),
            step_norm.to(dtype), rho.to(dtype), radius.to(dtype),
            accept.to(dtype), li.to(dtype)])
        row = torch.arange(self.block_attempts, device=rec.device)
        write = (row == s.n_rec) & valid & live

        # A re-prepare follows an accepted step (new parameters) or an
        # invalid one (the host loop breaks to its outer iteration, which
        # prepares again and charges it).
        need_prep = (accept | ~valid) & (term == TERM_RUNNING)
        exhausted = need_prep & (s.n_outer >= o.max_iterations)
        term = torch.where(exhausted, TERM_MAX_ITERATIONS, term)
        run_prep = need_prep & ~exhausted & live

        # Commit, all of it only where the attempt was live.
        taken = accept & live
        _select_into(taken, cand, s.params)
        if self.pair:
            _select_into(taken, rho_new, s.rho_ref)
        torch.where(taken, new_cost, s.cost, out=s.cost)
        torch.where(live, radius, s.radius, out=s.radius)
        torch.where(live, df, s.df, out=s.df)
        torch.where(live, inv, s.inv, out=s.inv)
        s.term.copy_(term)
        torch.where(write[:, None], rec[None, :], s.records, out=s.records)
        s.n_rec.add_((valid & live).to(torch.int32))
        s.run_prep.copy_(run_prep)
        s.flags.copy_(torch.stack([s.term, run_prep.to(torch.int32)]))

    def _refresh(self) -> None:
        """The end-of-attempt prepare, taken where ``run_prep`` is set."""
        s = self.state
        run = s.run_prep.clone()
        with trace.device_span("prepare"):
            aux = self.raw["prepare"](self.raw["bound"], s.params)
        cost, gmax, term = self._prep_checks(
            aux, torch.ones((), dtype=torch.bool, device=s.cost.device))
        _select_into(run, aux, s.aux)
        torch.where(run, cost, s.cost, out=s.cost)
        torch.where(run, gmax, s.gmax, out=s.gmax)
        torch.where(run & (s.term == TERM_RUNNING), term, s.term, out=s.term)
        s.n_outer.add_(run.to(torch.int32))
        s.run_prep.fill_(False)
        s.flags.copy_(torch.stack([s.term, torch.zeros_like(s.term)]))

    # --- block entry ------------------------------------------------------

    def start(self, params: Params, radius, df, inv, n_outer,
              charge: bool) -> None:
        """Enter a block: prepare at ``params``, seed ρ_ref, reset the
        block's counters.  ``charge`` says whether this prepare consumes
        an outer iteration (True on a solve's first block only)."""
        raw = self.raw
        bound = raw["bound"]
        aux = raw["prepare"](bound, params)
        self.prepares += 1
        rho_ref = raw["rho_slots"](bound, params) if self.pair else None
        dev, dtype = aux["cost"].device, aux["cost"].dtype
        cost0, gmax, term = self._prep_checks(
            aux, torch.tensor(bool(charge), device=dev))

        def scalar(v, dt):
            return torch.as_tensor(v, dtype=dt, device=dev).reshape(())

        i32 = torch.int32
        if self.state is None:
            clone = lambda t: t.clone()  # noqa: E731
            self.state = _LoopState(
                params=_tree_map(clone, params), aux=_tree_map(clone, aux),
                rho_ref=_tree_map(clone, rho_ref), cost=cost0.clone(),
                gmax=gmax.clone(), radius=scalar(radius, dtype).clone(),
                df=scalar(df, dtype).clone(), inv=scalar(inv, i32).clone(),
                n_outer=scalar(n_outer, i32).clone(),
                n_rec=scalar(0, i32),
                term=term.clone(),
                records=torch.zeros((self.block_attempts, N_REC),
                                    dtype=dtype, device=dev),
                run_prep=torch.zeros((), dtype=torch.bool, device=dev),
                flags=torch.zeros((2,), dtype=i32, device=dev),
                cost0=cost0.clone())
        s = self.state
        if params is not s.params:
            for dst, src in zip(_leaves(s.params), _leaves(params)):
                dst.copy_(src)
        for dst, src in zip(_leaves((s.aux, s.rho_ref)),
                            _leaves((aux, rho_ref))):
            dst.copy_(src)
        s.cost.copy_(cost0)
        s.cost0.copy_(cost0)
        s.gmax.copy_(gmax)
        s.radius.copy_(scalar(radius, dtype))
        s.df.copy_(scalar(df, dtype))
        s.inv.copy_(scalar(inv, i32))
        s.n_outer.copy_(scalar(n_outer, i32) + int(bool(charge)))
        s.n_rec.zero_()
        s.term.copy_(term)
        s.records.zero_()
        s.run_prep.fill_(False)
        if dev.type == "cuda" and self.graphs is None:
            self._capture()

    def _capture(self) -> None:
        """Warm both functions up on a side stream, put the state back,
        and capture them.  Whatever fails here raises."""
        with trace.span("loop.capture") as sp:
            self._capture_graphs()
        _Runner.capture_seconds += sp.seconds

    def _capture_graphs(self) -> None:
        counters = _kernel_counters()
        state = _leaves(self.state)
        saved = [t.clone() for t in state]
        side = _warmup_stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.state.run_prep.fill_(True)
            self._refresh()
            self._attempt()
        self.prepares += 1
        torch.cuda.current_stream().wait_stream(side)
        for t, keep in zip(state, saved):
            t.copy_(keep)
        torch.cuda.synchronize()

        # A capture records the kernels' launches and makes none: take what
        # the wrappers counted back, and count them on every replay instead.
        before = [c.launches for c in counters]
        trace.captured()              # what a failed capture may have left
        g_attempt = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g_attempt, pool=self.pool):
            with trace.device_span("attempt"):
                self._attempt()
        spans_attempt = trace.captured()
        in_attempt = [c.launches - n for c, n in zip(counters, before)]
        g_refresh = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g_refresh, pool=g_attempt.pool()):
            # timed as part of the attempt that asks for it
            with trace.device_span("attempt"):
                self._refresh()
        spans_refresh = trace.captured()
        in_refresh = [c.launches - n - a
                      for c, n, a in zip(counters, before, in_attempt)]
        for c, n in zip(counters, before):
            c.launches = n
        self.graphs = (g_attempt, g_refresh)
        self.spans = (spans_attempt, spans_refresh)
        self.kernel_nodes = (tuple(in_attempt), tuple(in_refresh))

    # --- one attempt, from the host ---------------------------------------

    def _run(self, which: int) -> None:
        """The attempt (0) or the re-prepare (1): eagerly, or as a replay
        of its graph, which then counts the kernel launches it holds."""
        if self.graphs is None:
            (self._attempt, self._refresh)[which]()
            self.prepares += which
            return
        self.graphs[which].replay()
        self.prepares += which
        for c, n in zip(_kernel_counters(), self.kernel_nodes[which]):
            c.launches += n

    def attempt(self) -> int:
        """One step attempt, and the prepare it asked for; returns the
        termination code as it stood after the attempt (a code that the
        prepare sets shows at the next call, which then changes nothing)."""
        with trace.span("loop.attempt") as sp:
            self._run(0)
            self.host_reads += 1
            term, run_prep = self.state.flags.tolist()
            self._read_spans()
            done = trace.resolve(self.spans[0], sp.record,
                                 self.device_seconds)
            if run_prep:
                self._run(1)
                if done:
                    self._unread = (done[0], sp.record)
        return term

    def _read_spans(self) -> None:
        """After a read-back: the device spans of the last re-prepare,
        whose seconds join its attempt's."""
        if self._unread is None:
            return
        into, host = self._unread
        self._unread = None
        trace.resolve(self.spans[1], host, self.device_seconds, into=into)

    def result(self) -> dict:
        """The block's outcome: the record table, the entry cost and the
        termination code in one read-back; the rest stays on the device."""
        s = self.state
        packed = torch.cat([s.records.reshape(-1),
                            torch.stack([s.n_rec, s.term]).to(s.cost.dtype),
                            s.cost0.reshape(1)]).tolist()
        self.host_reads += 1
        self._read_spans()
        n = self.block_attempts * N_REC
        return {"params": s.params, "radius": s.radius, "df": s.df,
                "inv": s.inv, "n_outer": s.n_outer,
                "records": [packed[i:i + N_REC] for i in range(0, n, N_REC)],
                "n_rec": int(packed[n]), "term": int(packed[n + 1]),
                "cost0": packed[n + 2]}


@functools.cache
def _warmup_stream() -> torch.cuda.Stream:
    """The side stream of every capture's warm-up.  One for the process:
    the first matmul on a stream allocates a cuBLAS workspace that the
    stream keeps, so a new stream per capture would hold memory for each."""
    return torch.cuda.Stream()


def make_device_runner(raw: dict, options: SolverOptions,
                       block_attempts: int, pool=None) -> _Runner:
    """The loop for one engine and one set of options (see ``_Runner``)."""
    return _Runner(raw, options, block_attempts, pool)


# --- engines kept across solves ----------------------------------------------

#: the most engines ``engines`` keeps; the least recently used goes first
ENGINE_CACHE_SIZE = 8

#: a problem's tensors that carry data (copied into a cached engine's
#: problem on a hit), and its index tensors (structure: equal on a hit)
_OBS_DATA = ("uv", "t", "mask")
_PROBLEM_DATA = ("pose_free", "point_free", "intr_free", "intr_basis")
_OBS_INDEX = ("pose_a", "pose_b", "intr_idx", "point")


def _data(problem: Problem) -> list:
    return ([getattr(problem.obs, f) for f in _OBS_DATA]
            + [getattr(problem, f) for f in _PROBLEM_DATA])


def _indices(problem: Problem) -> list:
    return [getattr(problem.obs, f) for f in _OBS_INDEX]


def _clone(problem: Problem) -> Problem:
    """A copy of ``problem`` whose tensors are its own."""
    obs = problem.obs
    return problem.replace(
        obs=obs.replace(**{f: getattr(obs, f).clone()
                           for f in _OBS_DATA + _OBS_INDEX}),
        **{f: getattr(problem, f).clone() for f in _PROBLEM_DATA})


@dataclasses.dataclass
class _Engine:
    fns: dict                 # phase functions bound to ``problem``, with
    #                           their runner in ``fns["_device_runners"]``
    problem: Problem          # the engine's own copy of a caller's problem
    index: torch.Tensor       # its index tensors end to end


class _EngineCache:
    """Flat engines and their runners, kept for later solves of the same
    structure, at most ``ENGINE_CACHE_SIZE`` of them.

    The key holds the options and the block size, the camera model and
    the loss, the shape, dtype and device of every tensor of the problem
    and the parameters, and whether tracing is on (a graph captured
    untraced holds no device spans).  A hit also needs the index tensors
    (``pose_a``, ``pose_b``, ``intr_idx``, ``point``) equal to the entry's,
    one comparison on the device and one read-back: what the engine built
    from them at make time (its groupings, its shapes, its size guards)
    then holds.  The engine's problem, a copy of the first caller's, then
    takes the caller's data (``uv``, ``t``, ``mask``, the free masks and
    the intrinsics basis) in place, where the captured graphs read it.
    A miss with an equal key replaces that key's entry.

    Only the engines whose make functions read nothing but shapes and
    index tensors may enter (``lm.rebindable``); the caller decides.
    """

    def __init__(self, size: int):
        self.size = size
        self._entries = collections.OrderedDict()
        self._pool = None

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        # The graph pool dies with the last graph captured into it: a
        # capture into its handle afterwards fails inside the allocator.
        self._entries.clear()
        self._pool = None

    def fns(self, problem: Problem, params: Params, options: SolverOptions,
            block_attempts: int, make) -> tuple:
        """``(fns, "hit" or "miss")`` for ``problem``; on a miss
        ``make(problem, options)`` builds the engine on a copy of it."""
        tensors = _data(problem) + _indices(problem) + _leaves(params)
        key = (block_attempts, options, problem.model, problem.loss,
               trace.enabled(),
               tuple((tuple(t.shape), t.dtype, t.device) for t in tensors))
        index = torch.cat([t.reshape(-1) for t in _indices(problem)])
        entry = self._entries.pop(key, None)
        if entry is not None and torch.equal(entry.index, index):
            for dst, src in zip(_data(entry.problem), _data(problem)):
                dst.copy_(src)
            self._entries[key] = entry
            return entry.fns, "hit"
        own = _clone(problem)
        fns = make(own, options)
        fns["_device_runners"] = {(block_attempts, options):
                                  make_device_runner(
                                      fns["raw"], options, block_attempts,
                                      pool=self._graph_pool(problem.device))}
        self._entries[key] = _Engine(fns, own, index)
        while len(self._entries) > self.size:
            self._entries.popitem(last=False)
        return fns, "miss"

    def _graph_pool(self, device: torch.device):
        """The memory pool every cached runner captures into (None off
        the card)."""
        if device.type != "cuda":
            return None
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool


#: the process's cache of engines (``lm.solve`` with no ``fns``)
engines = _EngineCache(ENGINE_CACHE_SIZE)


def block_size(options: SolverOptions, has_callback: bool) -> int:
    """Attempts per block.  Worst case ~17 rejections drive the radius
    from max to min; 4× the outer budget bounds any realistic attempt
    count, and a block that ends at the cap is simply followed by another
    (the termination code stays 0).  With a callback installed the blocks
    are shorter, so that it fires in time."""
    max_attempts = 4 * options.max_iterations
    if has_callback and options.device_block_iters > 0:
        return min(4 * options.device_block_iters, max_attempts)
    return max_attempts


def run_blocks(fns: dict, params, options: SolverOptions,
               summary: Summary, callback, to_external):
    """Drive the device loop to termination; fill ``summary`` in place.

    Runs in blocks of attempts, so that an installed ``callback`` still
    fires (once per accepted record, with the block's final parameters);
    without a callback the whole solve is one block.  Returns the final
    engine-internal params.
    """
    raw = fns["raw"]
    block_attempts = block_size(options, callback is not None)
    # The runner (and its captured graphs) is cached on the fns dict, so a
    # second solve with the same engine does not capture again.
    cache = fns.setdefault("_device_runners", {})
    key = (block_attempts, options)
    runner = cache.get(key)
    if runner is None:
        runner = cache[key] = make_device_runner(raw, options,
                                                 block_attempts)

    radius, df, inv, n_outer = options.initial_radius, 2.0, 0, 0
    charge = True
    reads_before = runner.host_reads
    runner.device_seconds = {}
    while True:
        t0 = time.perf_counter()
        runner.start(params, radius, df, inv, n_outer, charge)
        for _ in range(block_attempts):
            if runner.attempt() != TERM_RUNNING:
                break
        out = runner.result()
        block_wall = time.perf_counter() - t0
        if charge and not summary.iterations:     # not a resumed history
            summary.initial_cost = out["cost0"]
        params, radius, df, inv, n_outer = (
            out["params"], out["radius"], out["df"], out["inv"],
            out["n_outer"])
        charge = False
        term, n_rec, records = out["term"], out["n_rec"], out["records"]

        # Each record's wall is an even share of the block's.
        share = block_wall / max(n_rec, 1)
        cb_params = None
        for i in range(n_rec):
            cost, dcost, gmax, snorm, rho, rad, acc, li = records[i]
            it = IterationSummary(
                iteration=summary.num_iterations, cost=cost,
                cost_change=dcost, gradient_max_norm=gmax,
                step_norm=snorm, relative_decrease=rho,
                trust_region_radius=rad, accepted=bool(acc >= 0.5),
                linear_solver_iterations=int(li), wall_time=share)
            summary.iterations.append(it)
            if it.accepted:
                summary.num_successful_steps += 1
                # The callback fires once per accepted record, as in the
                # host loop; only its params argument is coarser (the
                # block's final parameters).
                if callback is not None:
                    if cb_params is None:
                        cb_params = (to_external(params)
                                     if to_external is not None else params)
                    callback(summary.num_iterations, cb_params, it)
            else:
                summary.num_unsuccessful_steps += 1
        if term != TERM_RUNNING:
            summary.termination, summary.message = _TERMINATIONS[term]
            break
    summary.host_reads += runner.host_reads - reads_before
    # Device phase times, where the graphs carry device spans (traced).
    dev = runner.device_seconds
    summary.evaluation_time += dev.get("prepare", 0.0) \
        + dev.get("residual_pass", 0.0)
    summary.linear_solver_time += dev.get("solve_step", 0.0)
    # The runner's tensors are overwritten by its next solve.
    return _tree_map(lambda t: t.clone(), params)
