"""Data parallelism over torch.distributed (counterpart of
cartseg_tpu/parallel/mesh.py, which lays a 1-D `jax.sharding.Mesh` over
the devices and lets GSPMD insert the collectives).

Here each rank is one process with one device. Training wraps the model
in `DistributedDataParallel` (train/engine.py), the BatchNorm layers sum
their statistics over the ranks (models/norm.py `sync_batch_norm`), and
each rank loads only its contiguous rows of every global batch
(`host_batch_slice`), so a step over the ranks equals the single-process
step over the global batch.

Backend rule (`backend_for`), printed once when the group starts:
  * NCCL when each rank on the host has a card of its own;
  * gloo on the CPU, and when ranks share one card (NCCL cannot run two
    ranks on one device). gloo carries `all_reduce` and `broadcast` of
    CUDA tensors through host memory: DDP broadcasts the parameters at
    its start and all-reduces the gradients, and the port's own
    collectives are all_reduce.

Inference does not use a process group: `shard_inference_program` splits
a batch by rows over the devices of this process (the local devices,
never a global count) and runs one replica of the program on each.
Nothing here sets a switch for the whole process: under DDP a hand
kernel is an ordinary op of each rank.
"""

from __future__ import annotations

import datetime
import os
import warnings
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

_TIMEOUT = datetime.timedelta(minutes=10)


def backend_for(device, local_world: int) -> str:
    """NCCL when `device` is a card and each of the host's `local_world`
    ranks has a card of its own; gloo otherwise."""
    dev = torch.device(device)
    if dev.type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def local_device(device, local_rank: Optional[int] = None) -> torch.device:
    """This rank's device: for a card, cuda:(local rank mod the host's
    cards) (ranks that outnumber the cards share them); the CPU as is."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local_rank % max(torch.cuda.device_count(),
                                                 1))


def init_distributed(rank: int, world_size: int, init_method: str,
                     device="cuda", local_rank: Optional[int] = None,
                     local_world: Optional[int] = None, log=print) -> str:
    """Start the default process group for this rank; returns the
    backend (`backend_for`). On a card the rank's device becomes the
    current one."""
    local_rank = rank if local_rank is None else local_rank
    local_world = world_size if local_world is None else local_world
    backend = backend_for(device, local_world)
    dev = local_device(device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=_TIMEOUT)
    if rank == 0:
        log(f"distributed: {backend} over {world_size} rank(s), device "
            f"{dev.type} (NCCL when each rank has a card of its own, "
            "gloo on the CPU or on a shared card)")
    return backend


def maybe_initialize_distributed(device="cuda", log=print) -> bool:
    """Start the process group from torchrun's environment (RANK,
    WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT).
    True when a group runs (it was running already, or it started here);
    False and nothing done in a plain single process."""
    if dist.is_available() and dist.is_initialized():
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    world = int(os.environ["WORLD_SIZE"])
    init_distributed(int(os.environ["RANK"]), world, "env://", device,
                     int(os.environ.get("LOCAL_RANK", "0")),
                     int(os.environ.get("LOCAL_WORLD_SIZE", world)), log)
    return True


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def local_device_count() -> int:
    """The cards this process sees (1 on a machine without one)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def is_main_process() -> bool:
    """True on the rank that writes files (CSVs, checkpoints, the
    synthetic tree); every rank in a single process."""
    return process_index() == 0


def _group_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier(name: str = "") -> None:
    """Every rank waits here for the others (nothing in a single
    process): an all_reduce of one element, the collective every backend
    carries. `name` is for the reader of a hang."""
    if process_count() > 1:
        dist.all_reduce(torch.zeros(1, device=_group_device()))


def host_batch_slice(n: int) -> slice:
    """This rank's contiguous rows [r k, (r+1) k) of a global batch of n
    rows, k = n / ranks (all of them in a single process). The epoch
    order stays global, so the ranks' rows together are the batch the
    single process sees. Raises where n does not divide over the ranks."""
    p, r = process_count(), process_index()
    if n % p:
        raise ValueError(f"global batch {n} not divisible by "
                         f"process_count {p}")
    k = n // p
    return slice(r * k, (r + 1) * k)


# --------------------------------------------------------- reductions

def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """t summed over the group's ranks, in place; t itself without a
    group."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_reduce_min(t: torch.Tensor, group=None) -> torch.Tensor:
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return t


def all_reduce_mean(t: torch.Tensor, group=None) -> torch.Tensor:
    """The mean over the ranks (a new tensor; t itself without a group)."""
    if group is None:
        return t
    t = t.clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t / dist.get_world_size(group)


def world_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def training_group(use_mesh: bool, batch_size: int):
    """The group a Trainer trains over: the default group when one runs
    and `use_mesh` is set, None otherwise. Raises where each rank would
    train alone (a group of several ranks with use_mesh off) and where the
    global batch does not divide over the ranks."""
    if not is_initialized():
        return None
    world = dist.get_world_size()
    if not use_mesh:
        if world > 1:
            raise ValueError(
                f"use_mesh=False under a process group of {world} ranks: "
                "each rank would train its own model on its own rows; set "
                "use_mesh=True or run one process")
        return None
    if batch_size % world:
        raise ValueError(f"global batch {batch_size} not divisible by "
                         f"process_count {world}")
    return dist.group.WORLD


# ---------------------------------------------------------- inference

def _device_of(program) -> torch.device:
    dev = getattr(program, "device", None)
    if dev is None:
        raise ValueError("shard_inference_program: the program names no "
                         "device (build it with pseudo_label_program or "
                         "mining_program)")
    return torch.device(dev)


def _normal(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _concat(outs: list, dev: torch.device):
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([o.to(dev) for o in outs], 0)
    if isinstance(first, dict):
        return {k: _concat([o[k] for o in outs], dev) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_concat([o[i] for o in outs], dev)
                           for i in range(len(first)))
    raise TypeError(f"cannot concatenate program outputs of type "
                    f"{type(first).__name__}")


def shard_inference_program(program: Callable, batch_size: int,
                            devices: Optional[Sequence] = None,
                            name: str = "inference",
                            log=print) -> Callable:
    """Data-parallel form of a per-batch inference program (JAX:
    mesh.py:62-106, over this process's devices).

    `program(images, *rest)` must carry `.device` (where its model
    lives) and `.replicate(device)` (the same program on another
    device), as `pseudo_label_program` and `mining_program` do. The
    returned program splits `images` by rows into len(devices)
    contiguous shards, runs each on its device's replica (`rest` passed
    to each as is) and concatenates the outputs, row for row, on the
    first device. `devices` defaults to every card of this process for a
    program on a card, and may repeat a device: a device listed twice
    runs one replica on two shards. One device leaves the program as it
    is; so does a batch_size that does not divide over the devices, with
    a warning."""
    home = _normal(_device_of(program))
    if devices is None:
        devices = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   if home.type == "cuda" else [home])
    devs = [_normal(d) for d in devices]
    if len(devs) <= 1:
        return program
    if batch_size % len(devs):
        warnings.warn(
            f"{name}: batch_size={batch_size} does not divide over the "
            f"{len(devs)} devices - sharding DISABLED; running on ONE "
            f"device. Pick batch_size a multiple of {len(devs)} or "
            "use_mesh=False to silence this.", stacklevel=2)
        return program
    replicas = {}
    for d in devs:
        if d not in replicas:
            replicas[d] = program if d == home else program.replicate(d)

    def sharded(images: torch.Tensor, *rest):
        parts = torch.tensor_split(images, len(devs))
        outs = [replicas[d](p.to(d), *rest) for d, p in zip(devs, parts)]
        return _concat(outs, devs[0])

    log(f"{name}: rows split over {len(devs)} devices "
        f"({', '.join(str(d) for d in devs)})")
    return sharded
