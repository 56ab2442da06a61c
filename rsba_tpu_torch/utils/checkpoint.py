"""Solver-state checkpointing for restartable long solves.

Counterpart of ``rsba_tpu/utils/checkpoint.py`` with the same methods
and the same ``history.json`` sidecar; the state itself is this package's
own format: one ``step_<iteration>.pt`` per kept step, written by
``torch.save`` from CPU tensors to a temporary name and renamed, and read
back with ``torch.load(weights_only=True)``.  Every accepted LM step can
persist (params, trust-region radius, iteration), so a job restarts from
the last accepted step with the CLI's ``--resume``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import warnings
from typing import Optional, Tuple

import torch

from ..problem.types import Params

_STEP = re.compile(r"^step_(\d+)\.pt$")


class SolverCheckpointer:
    """Persist and restore solver state per accepted LM step.

    Checkpointed: (iteration, params, trust-region radius), plus a JSON
    sidecar carrying (a) the accepted-step iteration history, so that a
    resumed run's Summary and JSONL continue instead of restarting from
    zero, and (b) a fingerprint of the SolverOptions the run was launched
    with (a resume with other options warns).  The ``keep`` newest steps
    stay on disk.

    Usage::

        ckpt = SolverCheckpointer(path, options=opts)
        start = ckpt.restore()            # None or (it, params, radius)
        history = ckpt.restore_history()  # [] or list[IterationSummary]
        lm.solve(problem, params, opts, callback=ckpt.callback,
                 summary=Summary(iterations=history))

    Under the on-device loop the callback fires once per accepted record
    with the block's final parameters, so the persisted parameters have
    block granularity there.
    """

    def __init__(self, directory: str, keep: int = 2,
                 every_n: int = 1, options=None):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        self.every_n = every_n
        self.options = options
        self._history: list = []
        os.makedirs(self.directory, exist_ok=True)

    @property
    def _history_path(self) -> str:
        return os.path.join(self.directory, "history.json")

    def _steps(self) -> list:
        """Iterations that have a state file, ascending."""
        return sorted(int(m.group(1)) for m in
                      map(_STEP.match, os.listdir(self.directory)) if m)

    def _write(self, name: str, write) -> None:
        """Write a file of the directory under a temporary name, then
        rename it over ``name``."""
        tmp = os.path.join(self.directory, name + ".tmp")
        write(tmp)
        os.replace(tmp, os.path.join(self.directory, name))

    def save(self, iteration: int, params: Params, radius: float) -> None:
        state = {
            "params": {f.name: getattr(params, f.name).detach().cpu()
                       for f in dataclasses.fields(params)},
            "radius": torch.tensor(float(radius), dtype=torch.float64),
        }
        self._write(f"step_{iteration}.pt", lambda p: torch.save(state, p))
        rec = {
            "iterations": self._history,
            "options": (dataclasses.asdict(self.options)
                        if self.options is not None else None),
        }

        def dump(path):
            with open(path, "w") as f:
                json.dump(rec, f)

        self._write("history.json", dump)
        steps = self._steps()
        for old in steps[:max(len(steps) - self.keep, 0)]:
            os.remove(os.path.join(self.directory, f"step_{old}.pt"))

    def wait(self) -> None:
        """Saves are synchronous; kept for the reference's interface."""

    def callback(self, iteration: int, params: Params, it_summary) -> None:
        """lm.solve callback: checkpoint each accepted step."""
        self._history.append(dataclasses.asdict(it_summary))
        if iteration % self.every_n == 0:
            self.save(iteration, params, it_summary.trust_region_radius)

    def restore(self, device=None) -> Optional[Tuple[int, Params, float]]:
        """(iteration, params, radius) of the newest step, or None.  The
        tensors come back on the CPU unless ``device`` is given."""
        steps = self._steps()
        if not steps:
            return None
        step = steps[-1]
        state = torch.load(os.path.join(self.directory, f"step_{step}.pt"),
                           weights_only=True)
        params = Params(**{k: v.to(device) if device is not None else v
                           for k, v in state["params"].items()})
        return step, params, float(state["radius"])

    def restore_history(self):
        """Persisted accepted-step history → list[IterationSummary].

        Also seeds the in-memory history, so that later saves append and
        do not truncate, and warns when the stored SolverOptions
        fingerprint differs from this run's.
        """
        from ..solver.summary import IterationSummary
        if not os.path.exists(self._history_path):
            return []
        with open(self._history_path) as f:
            rec = json.load(f)
        self._history = list(rec.get("iterations", []))
        stored = rec.get("options")
        if stored is not None and self.options is not None:
            cur = dataclasses.asdict(self.options)
            diff = {k: (stored[k], cur[k]) for k in cur
                    if k in stored and stored[k] != cur[k]
                    and k not in ("initial_radius", "verbose")}
            if diff:
                warnings.warn(
                    f"resuming with different solver options than the "
                    f"checkpointed run: {diff}")
        return [IterationSummary(**d) for d in self._history]
