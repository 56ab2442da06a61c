"""Faults planted in the program under a whole run, to read the numbers
that decide ``correct`` when the timed path is broken.

    python3 -m portbench.tools.faults --plant <name> --workload <cell>
        --seed <n> --seconds <s>

runs one cell once, as ``portbench.run`` does, with one fault planted
(on the card, at the cell's own size) and prints the result line.  The
benchmark's tests plant the same faults on the CPU at a small size.

Plants of the ``solve`` kind: ``unchanged`` (the solve returns its start),
``half`` (it solves with every other observation left out), ``altered``
(one point of its answer moved by 0.05).  Of the ``session`` kind:
``unregistered`` (frame 3's registration leaves the session as it was)
and ``altered`` (the reconstruction handed out has one rotation turned
by about 0.04 rad).
"""
from __future__ import annotations

import argparse
import json
import sys


def _wrap_solve(setattr_, before=None, after=None) -> None:
    from rsba_tpu_torch.solver import lm
    inner = lm.solve

    def solve(problem, params, options=lm.SolverOptions(), *a, **kw):
        if before is not None:
            problem = before(problem)
        p, s = inner(problem, params, options, *a, **kw)
        return after(params, p, s) if after is not None else (p, s)
    setattr_(lm, "solve", solve)


def _half(problem):
    m = problem.obs.mask.clone()
    m[1::2] = 0.0
    return problem.replace(obs=problem.obs.replace(mask=m))


def _altered_point(start, p, s):
    pts = p.points.clone()
    pts[0] += 0.05
    return p.replace(points=pts), s


def _session_unregistered(setattr_) -> None:
    from rsba_tpu_torch.pipeline.session import SfmSession
    inner = SfmSession._register

    def register(self, f):
        if f == 3:
            return {"frame": f, "event": "register_failed",
                    "registered": False}
        return inner(self, f)
    setattr_(SfmSession, "_register", register)


def _session_altered(setattr_) -> None:
    from rsba_tpu_torch.pipeline.session import SfmSession
    inner = SfmSession.reconstruction

    def reconstruction(self):
        q, c, pts = inner(self)
        q = q.copy()
        q[-2] = q[-2] + [0.0, 0.02, 0.0, 0.0]
        q[-2] /= (q[-2] ** 2).sum() ** 0.5
        return q, c, pts
    setattr_(SfmSession, "reconstruction", reconstruction)


PLANTS = {
    ("solve", "unchanged"): lambda s: _wrap_solve(
        s, after=lambda start, p, summary: (start, summary)),
    ("solve", "half"): lambda s: _wrap_solve(s, before=_half),
    ("solve", "altered"): lambda s: _wrap_solve(s, after=_altered_point),
    ("session", "unregistered"): _session_unregistered,
    ("session", "altered"): _session_altered,
}


def plant(kind: str, name: str, setattr_=setattr) -> None:
    """Plant fault ``name`` of traffic kind ``kind`` through ``setattr_``
    (pytest's ``monkeypatch.setattr`` in the tests)."""
    PLANTS[(kind, name)](setattr_)


def main(argv=None) -> int:
    from .. import manifest, run
    p = argparse.ArgumentParser(prog="python3 -m portbench.tools.faults")
    p.add_argument("--plant", required=True)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    bench = manifest.load()
    kind = manifest.traffic(manifest.cell(bench, args.workload)["traffic"])
    plant(kind["kind"], args.plant)
    out = run.execute(args.workload, args.seed, args.seconds, False,
                      bench=bench)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
