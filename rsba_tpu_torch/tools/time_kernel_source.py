"""Time other revisions of the fused kernel's source beside the current
one, on one card, in turns (the list forward, then backward).

    python3 -m rsba_tpu_torch.tools.time_kernel_source NAME[:earlier] ...

Each ``csrc/NAME.cu`` is a copy of ``csrc/fused_evaluate_assemble.cu``
from another revision, or with one part cut out to see what that part
costs.  ``NAME:earlier`` has the C interface from before the launch plan
(one thread per point column; the arguments end with the seven outputs
and the stream), and its outputs must agree with the current source's
within 1e-4 of max|current|; for the others the difference is printed
only.  All run at config 4's shapes in float32.  The loop calls the
library's C entry point itself (``kernels.fused._bind``), since the Python
wrapper takes longer than a short kernel.  Prints what ptxas reported
for each source, the atomic instructions in its SASS where ``cuobjdump``
is there, the times from CUDA events, and the card's name and power
limit.
"""
from __future__ import annotations

import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from ..kernels import build, fused
from ..problem import synthetic
from ..solver import banded_fused, window

CURRENT = "fused_evaluate_assemble"


def timed(f, n=50) -> float:
    """Milliseconds per call of ``f`` over ``n`` calls, by CUDA events."""
    f()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        f()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def sass_atomics(path) -> dict:
    """Counts of atomic instructions in a library's SASS."""
    sass = subprocess.run(["cuobjdump", "-sass", str(path)],
                          capture_output=True, text=True).stdout
    ops: dict[str, int] = {}
    for line in sass.splitlines():
        for op in ("ATOMS.CAS", "ATOMS", "ATOMG", "RED", "ATOM"):
            if f" {op}" in line:
                ops[op] = ops.get(op, 0) + 1
                break
    return ops


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    earlier = {a.split(":")[0]: a.endswith(":earlier") for a in argv}
    names = [CURRENT] + list(earlier)
    earlier[CURRENT] = False
    with ThreadPoolExecutor(len(names)) as pool:     # one nvcc per source
        libs = dict(zip(names, pool.map(build.Library, names)))
    for name in names:
        for line in libs[name].build_log.splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
                print(f"{name} ptxas: {line.strip()}", flush=True)
        if shutil.which("cuobjdump"):
            print(f"{name} SASS atomic instructions: "
                  f"{sass_atomics(libs[name].path)}", flush=True)

    ba = synthetic.CONFIGS["rs_slerp_robust"](scale=1.0, dtype=torch.float32)
    plan = window.build_window_plan(ba.problem)
    statics = banded_fused.kernel_statics(plan, ba.problem)
    params = banded_fused.to_internal(ba.params0, plan)
    inp = banded_fused.kernel_inputs(params, plan, ba.problem, statics)
    model, loss = ba.problem.model, ba.problem.loss
    stream = torch.cuda.current_stream().cuda_stream
    calls, outs = {}, {}
    for name in names:
        launch, outs[name] = fused._bind(libs[name].lib, stream, *inp, model,
                                         loss, with_plan=not earlier[name])

        def call(launch=launch, name=name):
            rc = launch()
            if rc != 0:
                raise RuntimeError(f"{name}: launch failed, error {rc}")

        calls[name] = call
        call()
    torch.cuda.synchronize()
    for name in names[1:]:
        worst = max(float((outs[name][k] - ref).abs().max())
                    / float(ref.abs().max())
                    for k, ref in outs[CURRENT].items())
        print(f"{name}: max|{name} - current| / max|current| over the "
              f"outputs {worst:.3e}", flush=True)
        if earlier[name] and not worst <= 1e-4:
            raise AssertionError(f"{name} differs from the current source")
    shape = (f"config-4 shapes (NR={plan.NR} W={plan.W} L={plan.L} "
             f"G={plan.G}, float32)")
    times = {name: [] for name in names}
    for name in names + names[::-1]:
        times[name].append(timed(calls[name]))
    for name in names:
        t = times[name]
        print(f"{name}: {t[0]:.4f} / {t[1]:.4f} ms per launch, mean "
              f"{0.5 * (t[0] + t[1]):.4f} ms, "
              f"{sum(t) / sum(times[CURRENT]):.2f}x current, {shape} "
              f"[{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
