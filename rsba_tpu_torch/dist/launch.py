"""Start the ranks of a sharded solve on this host.

``spawn(target, world_size, backend, device, *args)`` starts one process
per rank with the ``spawn`` start method, joins them in a process group
through a ``file://`` rendezvous in a temporary directory (no port to
race for when several test workers start worlds at once), calls
``target(mesh, *args)`` in each and returns the ranks' results in rank
order.  ``target`` must be a module-level function whose module the
ranks can import (it is pickled by name), and its result must be
picklable; the ranks hand their results back through ``torch.save``
files, so CUDA tensors come back on the CPU.  If a rank fails, the
others are stopped and ``spawn`` raises with its traceback.

``single_rank(backend, device)`` is a world of one rank in this process.
"""
from __future__ import annotations

import contextlib
import multiprocessing as mp
import multiprocessing.connection
import os
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from .. import default_device
from . import mesh as mesh_mod


#: PyTorch's CPU threads in each rank (several worlds of several ranks
#: may share a host's cores, as the tests' workers do)
RANK_THREADS = 1
#: how long spawn waits for its ranks (s)
TIMEOUT_S = 3600.0


def _rank_main(target, args, rank: int, world_size: int, backend: str,
               device: str, tmp: str) -> None:
    torch.set_num_threads(RANK_THREADS)
    try:
        dist.init_process_group(backend, init_method=f"file://{tmp}/rdzv",
                                rank=rank, world_size=world_size)
        try:
            result = target(mesh_mod.make_mesh(device), *args)
        finally:
            dist.destroy_process_group()
        torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _wait(procs) -> None:
    """Until every rank has ended, one has failed, or the time is up."""
    deadline = time.monotonic() + TIMEOUT_S
    while True:
        alive = [p for p in procs if p.exitcode is None]
        if not alive or any(p.exitcode not in (None, 0) for p in procs):
            return
        left = deadline - time.monotonic()
        if left <= 0:
            raise TimeoutError(f"ranks still running after {TIMEOUT_S} s")
        mp.connection.wait([p.sentinel for p in alive], timeout=left)


def spawn(target, world_size: int, backend, device, *args) -> list:
    """Run ``target(mesh, *args)`` on ``world_size`` new ranks; returns
    their results by rank.  ``backend`` None: NCCL on the card, gloo on
    the CPU (``mesh.resolve_backend``, which refuses an NCCL world larger
    than the visible cards); ``device`` None: the card."""
    device = default_device(device)
    backend = mesh_mod.resolve_backend(backend, device, world_size)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="rsba_dist_") as tmp:
        procs = [ctx.Process(target=_rank_main,
                             args=(target, args, rank, world_size, backend,
                                   str(device), tmp))
                 for rank in range(world_size)]
        for p in procs:
            p.start()
        try:
            _wait(procs)
        finally:
            for p in procs:
                if p.exitcode is None:
                    p.kill()
                p.join()
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            errs = []
            for r in failed:
                path = os.path.join(tmp, f"rank{r}.err")
                if os.path.exists(path):
                    with open(path) as f:
                        errs.append(f"rank {r}:\n{f.read()}")
            raise RuntimeError(
                f"rank(s) {failed} of {world_size} failed (exit codes "
                f"{[procs[r].exitcode for r in failed]})\n"
                + "\n".join(errs))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world_size)]


@contextlib.contextmanager
def single_rank(backend=None, device=None):
    """A process group of one rank in this process, for its Mesh."""
    device = default_device(device)
    backend = mesh_mod.resolve_backend(backend, device, 1)
    with tempfile.TemporaryDirectory(prefix="rsba_dist_") as tmp:
        dist.init_process_group(backend, init_method=f"file://{tmp}/rdzv",
                                rank=0, world_size=1)
        try:
            yield mesh_mod.make_mesh(device)
        finally:
            dist.destroy_process_group()
