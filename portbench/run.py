"""Run one cell of the benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout that holds the program (``rsba_tpu_torch``)
beside ``portbench/`` and ``BENCHMARK.json``.  The cell names a
configuration (``portbench/configs/<name>.json``) and a traffic mix
(``portbench/traffic/<name>.json``), whose ``kind`` is the module under
``portbench/kinds/`` that makes its inputs, warms up, drives the
measured window and decides ``correct`` against the limits in
``portbench/limits/<configuration>.<kind>.json``.  Each metric is read
by its own module, ``portbench/metrics/<metric name>.py``.

Set-up runs from the start of the process to the first timed request.
The window then runs for ``--seconds``; with ``--trace 1`` the traffic
kind profiles a bounded slice of it and the run reports the cell's
per-layer metrics, else its end-to-end ones.  Once the window has closed
and the program's state is freed, the kind compares what the window
produced with the reference.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``check``:
each number compared with its limit); the same numbers close standard
error.  Without a card, with fewer cards than the cell asks for, or with
JAX or the JAX package loaded, the run prints no result and exits 2.

``--control bf16`` runs the cell's control in the program's place (the
reference in bfloat16, the precision below the configuration's float32;
each traffic kind says what that is), to read the numbers that it fails.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

from . import T_START, manifest
from .record import Run

#: modules the measured process must not hold, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "rsba_tpu")
#: the GPU's caches, at fixed paths inside the checkout
CACHE = manifest.BENCH / ".cache"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def read_metric(name: str, run: Run):
    """The value of metric ``name`` in ``run`` by its reader, or None."""
    path = manifest.BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def execute(cell_name: str, seed: int, seconds: float, traced: bool,
            device="cuda", control: str = "none", bench: dict = None,
            cfg: dict = None, limits: dict = None) -> dict:
    """One run of a cell; returns the result line's object.  ``device``,
    ``bench``, ``cfg`` and ``limits`` are for the benchmark's own tests
    (a CPU run at a small size); a measured run takes the defaults."""
    import torch

    from .trace import Tracer
    bench = bench or manifest.load()
    cell = manifest.cell(bench, cell_name)
    cfg = cfg or manifest.config(bench, cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    kind = importlib.import_module(f"portbench.kinds.{traffic['kind']}")
    on_card = torch.device(device).type == "cuda"
    run = Run(kind=traffic["kind"])
    tracer = Tracer(traced and on_card)

    state = kind.setup(cfg, traffic, seed, device, control)
    if on_card:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    run.setup_s = time.perf_counter() - T_START
    kind.window(state, seconds, run, tracer)
    if on_card:
        torch.cuda.synchronize()
        run.peak_window_bytes = torch.cuda.max_memory_allocated()
        peak = max(setup_peak, run.peak_window_bytes)
    run.trace = tracer.summary()
    metrics = {}
    for m in manifest.metrics_of(bench, cell_name, traced):
        v = read_metric(m["name"], run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    kind.release(state)
    if on_card:
        torch.cuda.empty_cache()
    limits = limits or manifest.limits(cell["config"], traffic["kind"])
    checks = kind.check(state, run, limits, device)
    correct = all(v <= lim for _, v, lim in checks)
    out = {"correct": correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics}
    if on_card:
        out["device"] = {"platform": "gpu",
                         "kind": torch.cuda.get_device_name(0),
                         "count": int(cell["chips"]),
                         "memory_peak_bytes": int(peak),
                         "power_limit": _power_limit()}
    else:
        out["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                         "memory_peak_bytes": 0}
    if run.trace is not None:
        out["device"]["busy_s"] = run.trace["busy_s"]
        out["device"]["window_s"] = run.trace["window_s"]
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    out["check"] = {n: {"value": _finite(v), "limit": lim}
                    for n, v, lim in checks}
    return out


def _finite(v: float):
    """A number for the result line: JSON has no inf or nan."""
    return v if math.isfinite(v) else str(v)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.run",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("none", "bf16"), default="none")
    args = p.parse_args(argv)

    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
    import torch
    bench = manifest.load()
    chips = int(manifest.cell(bench, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    out = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                  control=args.control, bench=bench)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process holds {', '.join(bad)}",
              file=sys.stderr)
        return 2
    for name, c in out["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stderr.flush()
    # The result is out: leave without the interpreter's teardown, in
    # which the profiler's CUDA tracing library has crashed the process.
    os._exit(code)
