"""Process groups, the rank's device, and the rank's block of a problem.

Counterpart of ``rsba_tpu/dist/mesh.py``.  The reference drives every
chip from one JAX process through a ``Mesh`` and ``shard_map``; here each
rank is a process of its own on ``torch.distributed``, with one device:
the card by default, on the NCCL backend, or the CPU on gloo, as the
tests run it.  Two ranks on one card take gloo with CUDA tensors, which
offers ``all_reduce`` and ``broadcast`` only, so the sharded engines use
nothing but ``all_reduce``.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from .. import default_device
from ..problem.types import Params, Problem

#: name of the one mesh axis, as in the reference
AXIS = "dp"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in a sharded solve (the default process
    group): its rank, the world size, the device its tensors live on and
    the backend."""
    rank: int
    size: int
    device: torch.device
    backend: str
    #: all-reduces made through this Mesh and their bytes (per rank)
    counts: dict = dataclasses.field(
        default_factory=lambda: {"all_reduce": 0, "bytes": 0})

    def _all_reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM) -> None:
        self.counts["all_reduce"] += 1
        self.counts["bytes"] += x.numel() * x.element_size()
        dist.all_reduce(x, op=op)

    def psum(self, *tensors: torch.Tensor) -> tuple:
        """Each tensor summed over the ranks, packed into one all-reduce;
        returns new tensors and leaves the inputs as they are."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        self._all_reduce(flat)
        out, at = [], 0
        for t in tensors:
            out.append(flat[at:at + t.numel()].view(t.shape))
            at += t.numel()
        return tuple(out)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of ``x`` over the ranks."""
        x = x.clone()
        self._all_reduce(x, dist.ReduceOp.MAX)
        return x


def resolve_backend(backend, device: torch.device, ranks_here=None) -> str:
    """The backend for ranks on ``device``: ``None`` means NCCL on a CUDA
    device and gloo on the CPU.  NCCL refuses two ranks on one card, so
    ``ranks_here`` (the ranks that this host starts, where known) beyond
    the visible cards raises; ``backend="gloo"`` is the explicit way to
    put several ranks on one card."""
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"the NCCL backend needs a CUDA device, got "
                             f"{device}")
        n = torch.cuda.device_count()
        if ranks_here is not None and ranks_here > n:
            raise ValueError(
                f"an NCCL world of {ranks_here} ranks on this host needs "
                f"{ranks_here} CUDA devices, {n} visible; NCCL cannot put "
                'two ranks on one card (backend="gloo" can)')
    return backend


def rank_device(device, rank: int) -> torch.device:
    """A rank's device: ``cuda`` without an index means card
    ``rank % device_count`` (so every rank of a gloo world on a one-card
    host shares card 0)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", rank % torch.cuda.device_count())
    return device


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         backend: str | None = None,
                         device=None) -> dict:
    """Make this process one rank of a multi-process solve.

    Calls ``torch.distributed.init_process_group`` over
    ``tcp://coordinator_address`` (``HOST:PORT``) with the given world
    size and rank; with no coordinator, ``env://`` (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, as ``torchrun`` sets them).
    Run the same command in every process::

        python -m rsba_tpu_torch.cli.run --config=rs_mhost_pcg --shard \\
            --multihost --coordinator=HOST:PORT --num-processes=N \\
            --process-id=I

    ``device`` defaults to the card; a rank takes card
    ``process_id % device_count`` of its host.  Returns the reference's
    keys, {"process_id", "process_count", "global_devices",
    "local_devices"}, with one device per rank.
    """
    device = default_device(device)
    if coordinator_address is None:
        init = "env://"
        process_id = int(os.environ["RANK"]) if process_id is None \
            else process_id
    else:
        init = f"tcp://{coordinator_address}"
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num-processes and "
                             "--process-id")
    device = rank_device(device, process_id)
    backend = resolve_backend(backend, device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init, world_size=(
        -1 if num_processes is None else num_processes), rank=process_id)
    return {"process_id": dist.get_rank(),
            "process_count": dist.get_world_size(),
            "global_devices": dist.get_world_size(), "local_devices": 1}


def make_mesh(device=None) -> Mesh:
    """The Mesh of this rank in the default process group, which must be
    initialised.  ``device`` defaults to the card (``rank_device``)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group: "
                           "initialize_multihost, or dist.launch")
    rank = dist.get_rank()
    device = rank_device(default_device(device), rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(rank=rank, size=dist.get_world_size(), device=device,
                backend=str(dist.get_backend()))


def _chunk(n: int, mesh: Mesh, what: str) -> slice:
    if n % mesh.size:
        raise ValueError(f"{what} ({n}) not divisible by the world size "
                         f"({mesh.size}); repartition_by_point first")
    k = n // mesh.size
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def shard_problem(problem: Problem, mesh: Mesh) -> Problem:
    """This rank's block of a problem in the ``repartition_by_point``
    layout, on the rank's device: its observation rows and its chunk of
    points (observations keep global point indices); poses and
    intrinsics whole."""
    rows = _chunk(problem.obs.n_obs, mesh, "observations")
    pts = _chunk(problem.point_free.shape[0], mesh, "points")
    dev = mesh.device
    obs = problem.obs
    return problem.replace(
        obs=obs.replace(**{f.name: getattr(obs, f.name)[rows].to(dev)
                           for f in dataclasses.fields(obs)}),
        pose_free=problem.pose_free.to(dev),
        point_free=problem.point_free[pts].to(dev),
        intr_free=problem.intr_free.to(dev),
        intr_basis=problem.intr_basis.to(dev))


def shard_params(params: Params, mesh: Mesh) -> Params:
    """This rank's chunk of the points, on the rank's device; poses and
    intrinsics whole."""
    pts = _chunk(params.n_points, mesh, "points")
    return Params(q=params.q.to(mesh.device), c=params.c.to(mesh.device),
                  intr=params.intr.to(mesh.device),
                  points=params.points[pts].to(mesh.device))


def shard_ba(problem: Problem, params: Params, mesh: Mesh
             ) -> tuple[Problem, Params]:
    """This rank's block of a repartitioned problem and its parameters
    (the reference's ``device_put`` onto the mesh)."""
    return shard_problem(problem, mesh), shard_params(params, mesh)
