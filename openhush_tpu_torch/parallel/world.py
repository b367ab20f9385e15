"""The ranks of a torch.distributed world, one process a device.

Where the reference lays a JAX mesh over the devices one process sees, the
port runs one process a device (a rank) and writes every collective out
(parallel/sharding.py). This module starts, joins and tears down the ranks:

- `resolve_backend`: NCCL on CUDA, a card a rank; gloo on the CPU. NCCL
  refuses two ranks on one card, so a CUDA world with more ranks than cards
  raises unless the caller asks for gloo by name (gloo takes CUDA tensors
  for all_reduce and broadcast, through the host). Gloo is never chosen
  silently.
- `init_world`: one rank's process group and card, with a timeout
  (TIMEOUT), so that a collective that never completes raises instead of
  hanging.
- `run_world`: spawns the ranks, runs `fn(*args)` in each (one intra-op
  thread a rank), and returns the ranks' results in rank order. A rank that
  raises or dies fails the call, and the other ranks are stopped.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from openhush_tpu_torch.device import resolve_device

# How long a collective may wait for its peers before it raises.
TIMEOUT = datetime.timedelta(seconds=300)


def resolve_backend(device: torch.device, world_size: int,
                    backend: Optional[str] = None) -> str:
    """The process-group backend for `world_size` ranks on `device`'s
    type: gloo on the CPU; on CUDA NCCL, or gloo when asked for by name."""
    if device.type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r} on the CPU: only gloo "
                             f"runs there")
        return "gloo"
    if backend == "gloo":
        return "gloo"
    if backend not in (None, "nccl"):
        raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")
    cards = torch.cuda.device_count()
    if world_size > cards:
        raise RuntimeError(
            f"{world_size} ranks on {cards} card(s): NCCL refuses two ranks "
            f"on one GPU; pass backend='gloo' to run them on fewer cards")
    return "nccl"


def init_world(rank: int, world_size: int, init_method: str, device=None,
               backend: Optional[str] = None) -> str:
    """Join rank `rank` of a world of `world_size` ranks (init_method: a
    `file://` or `tcp://` rendezvous) and
    select its card: `device`'s when it names one, else card rank mod the
    card count (a card a rank under NCCL; under gloo the ranks shared
    round-robin over the cards). Returns the backend."""
    dev = resolve_device(device)
    backend = resolve_backend(dev, world_size, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=TIMEOUT)
    return backend


def _rank_main(rank: int, fn: Callable, args: tuple, world_size: int,
               device: str, backend: str, tmp: str) -> None:
    torch.set_num_threads(1)
    init_world(rank, world_size, f"file://{os.path.join(tmp, 'rendezvous')}",
               device, backend)
    try:
        result = fn(*args)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def run_world(fn: Callable, world_size: int, *args, device=None,
              backend: Optional[str] = None) -> list[Any]:
    """Spawn `world_size` ranks on `device` (None means CUDA), run
    `fn(*args)` in each and return their results in rank order. `fn` must
    be importable by name (a module-level function of a module that a
    fresh interpreter can import) and its results picklable; `backend` as
    `resolve_backend` takes it."""
    dev = resolve_device(device)
    backend = resolve_backend(dev, world_size, backend)
    with tempfile.TemporaryDirectory(prefix="openhush-world-") as tmp:
        mp.start_processes(_rank_main, args=(fn, args, world_size, str(dev),
                                             backend, tmp),
                           nprocs=world_size, join=True,
                           start_method="spawn")
        results = []
        for rank in range(world_size):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
