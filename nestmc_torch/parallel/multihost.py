"""Multi-process runs on torch.distributed: one process a rank.

Call :func:`initialize` once in every process before the run. It reads
its arguments, else NESTMC_COORDINATOR_ADDRESS / NESTMC_NUM_PROCESSES /
NESTMC_PROCESS_ID, else torchrun's MASTER_ADDR:MASTER_PORT / WORLD_SIZE /
RANK; with none of them set it does nothing, so one entry point serves a
single process too. The address is ``host:port`` (TCP rendezvous) or a
``file://`` path (a shared file, as the tests use).

The backend follows from the topology, never from a failed attempt:
NCCL when every rank of the host has a card of its own; gloo when the
ranks run on the CPU, or when several ranks share a card (rank r then
uses ``cuda:{local_rank % device_count}``). Ranks run on the card unless
``device='cpu'`` is asked for; without a card that is an error. The
choice is logged and kept (:func:`backend`, :func:`device`).

Checkpoints of a multi-process run are written by the primary only
(:func:`is_primary`): every rank's generators are the same, and the
engine gathers the carry to its global layout before writing.
"""

from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist

log = logging.getLogger("nestmc_torch")

_CHOICE = {"backend": None, "device": None}


def _env(name: str) -> str | None:
    v = os.environ.get(name)
    return None if v in (None, "") else v


def _env_int(name: str) -> int | None:
    v = _env(name)
    return None if v is None else int(v)


def _torchrun_address() -> str | None:
    host, port = _env("MASTER_ADDR"), _env("MASTER_PORT")
    return None if host is None or port is None else f"{host}:{port}"


def topology(num_processes: int, process_id: int, device=None) -> tuple:
    """(backend, torch.device) of rank ``process_id``: see the module
    docstring. LOCAL_RANK / LOCAL_WORLD_SIZE (torchrun) place ranks on a
    host; without them every rank is taken to be on this host."""
    if device == "cpu":
        return "gloo", torch.device("cpu")
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("multihost: no card; pass device='cpu' for "
                           "ranks on the CPU")
    local_rank = _env_int("LOCAL_RANK")
    local_world = _env_int("LOCAL_WORLD_SIZE")
    if local_rank is None:
        local_rank = process_id
    if local_world is None:
        local_world = num_processes
    dev = torch.device("cuda", local_rank % cards)
    return ("nccl" if local_world <= cards else "gloo"), dev


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str | None = None,
) -> None:
    """torch.distributed.init_process_group with the env fallbacks above
    (explicit arguments win, then NESTMC_*, then torchrun's); a no-op
    when neither an address nor a process count is configured, or when
    the process group already exists."""
    if coordinator_address is None:
        coordinator_address = _env("NESTMC_COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = _env_int("NESTMC_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("NESTMC_PROCESS_ID")
    if coordinator_address is None:
        coordinator_address = _torchrun_address()
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    if coordinator_address is None and num_processes is None:
        return                                          # one process
    if dist.is_initialized():
        return
    process_id = process_id or 0
    backend, dev = topology(num_processes, process_id, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if coordinator_address is None:
        init = "env://"
    elif "://" in coordinator_address:
        init = coordinator_address
    else:
        init = f"tcp://{coordinator_address}"
    dist.init_process_group(backend=backend, init_method=init,
                            world_size=num_processes, rank=process_id)
    _CHOICE.update(backend=backend, device=dev)
    log.info("multihost: rank %d of %d, backend %s on %s", process_id,
             num_processes, backend, dev)


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def is_primary() -> bool:
    """True in rank 0 and in a process that is not part of a group."""
    return rank() == 0


def rank() -> int:
    return dist.get_rank() if _initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if _initialized() else 1


def backend() -> str | None:
    """The backend :func:`initialize` chose, else that of a process group
    made another way; None in a process that is not part of a group."""
    if _CHOICE["backend"] is None and _initialized():
        return dist.get_backend()
    return _CHOICE["backend"]


def device() -> torch.device | None:
    """The device :func:`initialize` gave this rank (None before)."""
    return _CHOICE["device"]
