"""Start D ranks of a ``torch.distributed`` world on this host.

``spawn(fn, world, args)`` (or ``start(...).wait()``) starts ``world``
processes with the ``spawn``
start method (never ``fork``: the caller may be multithreaded, as a
process that has imported JAX is), initializes the process group in each
from a ``file://`` store, calls ``fn(rank, world, *args)`` and tears the
group down.  A rank that raises fails the call: ``start_processes``
raises ``ProcessRaisedException`` in the caller and stops the other
ranks.

The backend is ``nccl`` when each rank owns a card (``world`` at most the
number of CUDA devices; rank r uses ``cuda:r``) and ``gloo`` otherwise —
CPU ranks, or several ranks sharing one card, which NCCL refuses.  ``fn``
must be importable by the children (a module-level function).
"""
from __future__ import annotations

import datetime
import os
import tempfile
from typing import Callable, Optional, Sequence

import torch


def default_backend(world: int) -> str:
    """``nccl`` when every rank can own a CUDA card, else ``gloo``."""
    if torch.cuda.is_available() and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _rank_main(rank: int, fn: Callable, world: int, backend: str,
               store: str, threads: Optional[int], timeout_s: float,
               args: Sequence):
    import torch.distributed as dist
    if threads is not None:
        torch.set_num_threads(threads)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(
        backend, init_method="file://" + store, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


class Ranks:
    """A started world (``start``): ``wait()`` returns when every rank has
    returned and raises if one failed."""

    def __init__(self, ctx, tmp):
        self._ctx = ctx
        self._tmp = tmp

    def wait(self) -> None:
        try:
            while not self._ctx.join():
                pass
        finally:
            self._tmp.cleanup()


def start(fn: Callable, world: int, args: Sequence = (),
          store_dir: Optional[str] = None, threads: Optional[int] = None,
          timeout_s: float = 600.0) -> Ranks:
    """Start ``fn(rank, world, *args)`` on ``world`` spawned ranks of one
    process group (``default_backend(world)``), its ``file://`` store in
    ``store_dir`` (default: a new temporary directory), and return
    without waiting.  ``threads`` sets each rank's
    ``torch.set_num_threads``; ``timeout_s`` bounds every collective."""
    from torch.multiprocessing import start_processes
    backend = default_backend(world)
    tmp = tempfile.TemporaryDirectory(dir=store_dir)
    store = os.path.join(tmp.name, "store")
    ctx = start_processes(_rank_main, args=(fn, world, backend, store,
                                            threads, timeout_s, tuple(args)),
                          nprocs=world, join=False, start_method="spawn")
    return Ranks(ctx, tmp)


def spawn(fn: Callable, world: int, args: Sequence = (), **kw) -> None:
    """``start(fn, world, args, **kw).wait()``: run the ranks to their
    end; raises if one failed."""
    start(fn, world, args, **kw).wait()
