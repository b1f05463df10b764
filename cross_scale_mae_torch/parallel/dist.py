"""Process bootstrap for data-parallel training (counterpart of
``cross_scale_mae_tpu/parallel/dist.py``).

One process per GPU, the torch idiom. A JAX process is a host with all of
its chips; a port process is one GPU, rank r bound to ``cuda:LOCAL_RANK``.
The group is NCCL on the card and gloo on the CPU, and it is joined either
from the torchrun environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``/``MASTER_PORT``) or from the JAX package's flags
(``--coordinator_address host:port --num_processes W --process_id r``, a
``tcp://`` rendezvous). A run given neither is the single-process run:
world size 1 and no process group. A run given either has a group even at
world size 1, and its collectives run there as they would across four
cards.

A collective that waits longer than ``timeout_s`` raises (a peer that died
or took another path), so a desynchronised run fails instead of hanging.

The mesh (:func:`init_mesh`, the JAX package's ``make_mesh``): the world of
n = dp x tp ranks as a (data, model) grid, rank = d * tp + m, the model axis
the fast one (``np.asarray(devices).reshape(n // tp, tp)``). The data group
holds the ranks of one m (the gradient average, the global batch's
collectives), the model group those of one d (tensor and sequence
parallelism). Without :func:`init_mesh` the mesh is (world, 1).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Where this process runs: its rank among ``world_size`` and its
    device. ``distributed`` says whether a process group carries the run
    (True even at world size 1 when the flags or torchrun asked for one)."""

    rank: int
    world_size: int
    device: torch.device
    distributed: bool


def resolve_device(device: torch.device | str) -> torch.device:
    """The device to run on; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} asked for, but torch.cuda.is_available() is "
            "False; pass device='cpu' (--device cpu) to run on the CPU")
    return dev


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device: torch.device | str = "cuda",
                           timeout_s: float = TIMEOUT_S) -> Runtime:
    """Join the process group the flags or the torchrun environment name
    and return this process's :class:`Runtime`; without either, the
    single-process runtime on ``device``. A ``cuda`` device without an
    index becomes ``cuda:LOCAL_RANK`` (with the flags and no
    ``LOCAL_RANK``: the process id modulo the visible cards). Idempotent: a
    second call in one process returns the group it joined."""
    flags = (coordinator_address, num_processes, process_id)
    if any(f is not None for f in flags) and any(f is None for f in flags):
        raise SystemExit("--coordinator_address, --num_processes and --process_id "
                         "go together")
    env = os.environ
    if coordinator_address is not None:
        init = f"tcp://{coordinator_address}"
        rank, world = int(process_id), int(num_processes)
        if not 0 <= rank < world:
            raise SystemExit(f"--process_id {rank} is not a rank of --num_processes {world}")
        local = int(env.get("LOCAL_RANK", rank % max(torch.cuda.device_count(), 1)))
    elif "RANK" in env and "WORLD_SIZE" in env:
        init = "env://"
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        local = int(env.get("LOCAL_RANK", 0))
    else:
        return Runtime(0, 1, resolve_device(device), False)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if (dist.get_rank(), dist.get_world_size()) != (rank, world):
            raise RuntimeError(
                f"a process group of rank {dist.get_rank()} of {dist.get_world_size()} "
                f"exists; asked for rank {rank} of {world}")
        return Runtime(rank, world, dev, True)
    kw: dict[str, Any] = {"device_id": dev} if dev.type == "cuda" else {}
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=init,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return Runtime(rank, world, dev, True)


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """Rank 0, or the single process: the one that logs and writes files."""
    return rank() == 0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on the (data, model) grid and the groups of its
    row and column: None without a process group, and the model group None
    at tp 1 (no model collective)."""

    dp: int
    tp: int
    d: int
    m: int
    data: Any = None
    model: Any = None


_MESH: Optional[Mesh] = None


def init_mesh(model_parallel: int = 1, num_slices: int = 1,
              rt: Optional[Runtime] = None) -> Mesh:
    """The (data, model) mesh over the process group (of ``rt``, by
    default the one this process joined): the JAX package's ``make_mesh``
    check ``n % (model_parallel * num_slices) == 0`` (off a TPU the slices
    change nothing else), then one data group per m and one model group per
    d (``dist.new_group``, made in the same order on every rank).
    SystemExit when the world does not split."""
    global _MESH
    n = rt.world_size if rt is not None else world_size()
    tp = int(model_parallel or 1)
    if tp < 1 or num_slices < 1 or n % (tp * num_slices):
        raise SystemExit(f"{n} process(es) do not split into --model_parallel {tp} x "
                         f"--num_slices {num_slices} (the JAX make_mesh check "
                         f"n % (model_parallel * num_slices) == 0)")
    dp, r = n // tp, rt.rank if rt is not None else rank()
    data = model = None
    if dist.is_initialized():
        data = dist.group.WORLD
        if tp > 1:
            for m in range(tp):
                g = dist.new_group([d * tp + m for d in range(dp)])
                if m == r % tp:
                    data = g
            for d in range(dp):
                g = dist.new_group([d * tp + m for m in range(tp)])
                if d == r // tp:
                    model = g
    _MESH = Mesh(dp, tp, r // tp, r % tp, data, model)
    return _MESH


def mesh() -> Mesh:
    """This rank's :class:`Mesh`: the one :func:`init_mesh` made, else
    (world, 1) with the world as the data group."""
    if _MESH is not None:
        return _MESH
    return Mesh(world_size(), 1, rank(), 0,
                dist.group.WORLD if dist.is_initialized() else None, None)


def data_group():
    """The ranks that share this rank's model index (None: no collective)."""
    return mesh().data


def model_group():
    """The ranks that share this rank's data index (None: no collective)."""
    return mesh().model


def reset_mesh() -> None:
    global _MESH
    _MESH = None


def barrier() -> None:
    """Every rank waits here for the others; nothing without a group."""
    if dist.is_initialized():
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def broadcast_object(obj: Any) -> Any:
    """Rank 0's ``obj`` on every rank (a run directory rank 0 chose)."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def shutdown() -> None:
    """Leave the process group, if any; a second call does nothing."""
    reset_mesh()
    if dist.is_initialized():
        dist.destroy_process_group()
