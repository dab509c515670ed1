"""Joining a ``torch.distributed`` world (counterpart of ``init_distributed``,
``deepspeed_tpu/platform/accelerator.py:190-215``).

One process per device: a process drives ``cuda:LOCAL_RANK`` over NCCL, or
the CPU over ``gloo`` when the caller asks for ``device="cpu"`` (the tests'
multi-rank worlds). A single process needs no call, as in JAX: with no
world size given anywhere, the call does nothing and the engine trains on
its one device with no process group.

The world comes from the arguments, else from the JAX package's variables
(``DSTPU_NUM_PROCESSES``, ``DSTPU_PROCESS_ID``, ``DSTPU_COORDINATOR`` as
``host:port``), else from PyTorch's (``WORLD_SIZE``, ``RANK``,
``MASTER_ADDR`` / ``MASTER_PORT``, ``LOCAL_RANK``). There is no fallback:
an NCCL init that fails raises, and nothing retries on ``gloo``.
"""

from __future__ import annotations

import os
import socket
from typing import Optional

import torch

from ..utils.logging import log_dist
from .device import DeviceLike, resolve_device


def _env_int(*names: str) -> Optional[int]:
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return int(v)
    return None


def _free_port() -> int:
    """A free TCP port on localhost (a world of one needs a rendezvous
    address too)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     device: DeviceLike = None) -> Optional[torch.device]:
    """Join the world; returns this rank's device, or None in
    single-process mode (no world size given: nothing to join).

    ``device`` None or ``"cuda"``: NCCL on ``cuda:LOCAL_RANK`` (``LOCAL_RANK``
    defaults to the rank modulo the visible cards); raises without a card.
    ``device="cpu"``: ``gloo``. A world of one (``WORLD_SIZE=1``) is joined
    too: the engine then runs its collectives over a group of one rank."""
    import torch.distributed as dist

    if num_processes is None:
        num_processes = _env_int("DSTPU_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("DSTPU_PROCESS_ID", "RANK")
    coordinator_address = coordinator_address \
        or os.environ.get("DSTPU_COORDINATOR")
    if coordinator_address is None and os.environ.get("MASTER_ADDR") \
            and os.environ.get("MASTER_PORT"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
    if num_processes is None:
        log_dist("init_distributed: single-process mode (no world size)")
        return None
    if num_processes < 1:
        raise ValueError(f"init_distributed: world size {num_processes}")
    if process_id is None:
        if num_processes > 1:
            raise ValueError("init_distributed: a world above 1 needs this "
                             "process's rank (DSTPU_PROCESS_ID or RANK)")
        process_id = 0
    if not 0 <= process_id < num_processes:
        raise ValueError(f"init_distributed: rank {process_id} outside a "
                         f"world of {num_processes}")
    if coordinator_address is None:
        if num_processes > 1:
            raise ValueError("init_distributed: a world above 1 needs a "
                             "coordinator address (DSTPU_COORDINATOR, or "
                             "MASTER_ADDR and MASTER_PORT)")
        coordinator_address = f"localhost:{_free_port()}"
    if dist.is_initialized():
        raise RuntimeError("init_distributed: a process group is already up")
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = _env_int("LOCAL_RANK")
        if local is None:
            local = process_id % torch.cuda.device_count()
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    log_dist(f"init_distributed: rank {process_id} of {num_processes} over "
             f"{backend} on {dev}", ranks=[0])
    return dev
