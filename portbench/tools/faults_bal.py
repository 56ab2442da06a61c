"""The ``solve`` kind's faults (``tools/faults.py``) planted under a whole
run of a ``solve_bal`` cell, which drives the program through the same
``lm.solve``:

    python3 -m portbench.tools.faults_bal --plant <name> --workload <cell>
        --seed <n> --seconds <s>

``unchanged`` (the solve returns its start), ``half`` (it solves with
every other observation left out), ``altered`` (one point of its answer
moved by 0.05); prints the result line.
"""
from __future__ import annotations

import argparse
import json
import sys

from .faults import plant


def main(argv=None) -> int:
    from .. import run
    p = argparse.ArgumentParser(prog="python3 -m portbench.tools.faults_bal")
    p.add_argument("--plant", required=True,
                   choices=("unchanged", "half", "altered"))
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    plant("solve", args.plant)
    out = run.execute(args.workload, args.seed, args.seconds, False)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
