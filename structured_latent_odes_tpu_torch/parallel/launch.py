"""Starting the ranks: one process per rank under ``torch.distributed``.

The JAX package is one process over a device mesh; the port runs one process
per rank. :func:`run_ranks` runs a function on ``world`` ranks: under
``torchrun`` (its variables in the environment) it joins the group torchrun
made; otherwise it spawns the ranks itself with the ``spawn`` start method
(``fork`` breaks once CUDA is initialised), on a free port of
``127.0.0.1``. The backend follows the device: NCCL on CUDA (one card per
rank), gloo on the CPU; a caller may name another, as two ranks sharing one
card must (NCCL refuses two ranks on one GPU, gloo takes CUDA tensors for
``all_reduce``, ``all_gather`` and ``broadcast``).

:class:`RankPool` keeps the spawned ranks for several calls, so that a test
module or a smoke run pays their start once. Every collective has a time
limit (``timeout_s``, handed to ``init_process_group``), and a pool's call has
its own limit in the parent: a hung collective fails the call, and the pool
stops its processes.
"""

from __future__ import annotations

import datetime
import io
import os
import queue
import socket
import sys
import time
import traceback
from typing import Callable, List, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from structured_latent_odes_tpu_torch.utils import memo

# a collective waits at most this long for its peers
DEFAULT_TIMEOUT_S = 600
_TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def under_torchrun() -> bool:
    """Whether torchrun (or another launcher with its variables) started
    this process and no group is up yet."""
    return not dist.is_initialized() and all(k in os.environ for k in _TORCHRUN_VARS)


def is_writer() -> bool:
    """Whether this process writes the run's files: rank 0, or a process
    outside any group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def rank0_first(fn: Callable):
    """``fn()`` on rank 0, then, after a barrier, on the other ranks: for a
    step that writes a shared file on first use (a generated dataset), so
    that the others read it whole. Outside a group, ``fn()``."""
    if not dist.is_initialized():
        return fn()
    if dist.get_rank() == 0:
        out = fn()
        _barrier()
        return out
    _barrier()
    return fn()


def _barrier() -> None:
    """A barrier of the world; on NCCL, on the card this rank took
    (:func:`card_index`), which NCCL would otherwise guess."""
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def _leave_group() -> None:
    """Destroy this process's group, after dropping every captured CUDA
    graph (``utils/memo.py::clear_all``): NCCL does not destroy a
    communicator while a graph that captured its collectives is alive, and
    on four H100s ranks that still held such graphs did not leave
    ``destroy_process_group`` before their pool killed them."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    memo.clear_all()
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dumps(obj) -> bytes:
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def _loads(data: bytes):
    return torch.load(io.BytesIO(data), map_location="cpu", weights_only=False)


def card_index(device, local_rank: int) -> Optional[int]:
    """The card a rank takes on ``device``: the one it names where it has an
    index (every rank on that card, as ranks sharing one card over gloo
    are), else the rank's local index (one card a rank: ``"cuda"``); None
    off CUDA."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return device.index if device.index is not None else local_rank


def _set_card(device: torch.device, local_rank: int) -> None:
    card = card_index(device, local_rank)
    if card is not None:
        torch.cuda.set_device(card)


def _rank_loop(rank: int, world: int, addr: str, backend: str, device: str, timeout_s: float, threads: int,
               quiet: bool, tasks, results) -> None:
    """A spawned rank: join the group, then run each task the parent sends
    (a picklable function and its arguments) until it sends None, posting
    ``(rank, ok, result bytes or traceback)``."""
    torch.set_num_threads(threads)
    os.environ["LOCAL_RANK"] = str(rank)
    if quiet and rank:
        sys.stdout = open(os.devnull, "w")
    _set_card(torch.device(device), rank)
    dist.init_process_group(backend, init_method=addr, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        while True:
            item = tasks.get()
            if item is None:
                break
            fn, args = item
            try:
                results.put((rank, True, _dumps(fn(*args))))
            except BaseException:  # noqa: BLE001 - reported to the parent, which raises
                results.put((rank, False, traceback.format_exc()))
    finally:
        _leave_group()


class RankPool:
    """``world`` spawned ranks in one process group (``backend``, default
    :func:`backend_for` ``device``), kept for several calls.

    ``run(fn, *args)`` runs ``fn(*args)`` on every rank (``fn`` a
    module-level function, picklable by name) and returns the ranks' results
    in rank order, tensors on the CPU. A rank that raises, a rank that dies
    and a call past ``timeout_s`` raise in the parent and close the pool.
    Ranks run at ``threads`` intra-op threads (default: the parent's);
    ``quiet`` sends the standard output of ranks other than 0 to
    ``os.devnull``."""

    def __init__(self, world: int, *, device="cpu", backend: Optional[str] = None,
                 timeout_s: float = DEFAULT_TIMEOUT_S, threads: Optional[int] = None, quiet: bool = False):
        ctx = mp.get_context("spawn")
        self.world = world
        self.timeout_s = timeout_s
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(world)]
        addr = f"tcp://127.0.0.1:{_free_port()}"
        backend = backend or backend_for(device)
        threads = threads or torch.get_num_threads()
        self._procs = [
            ctx.Process(target=_rank_loop, args=(r, world, addr, backend, str(device), timeout_s, threads, quiet,
                                                  self._tasks[r], self._results), daemon=True)
            for r in range(world)
        ]
        for p in self._procs:
            p.start()

    def run(self, fn: Callable, *args, timeout_s: Optional[float] = -1) -> List:
        """Results of ``fn(*args)`` per rank. ``timeout_s``: the call's limit
        (default: the collectives' limit and a minute; None: no limit)."""
        if not self._procs:
            raise RuntimeError("the rank pool is closed")
        limit = self.timeout_s + 60 if timeout_s == -1 else timeout_s
        deadline = None if limit is None else time.monotonic() + limit
        for q in self._tasks:
            q.put((fn, args))
        outs, errors, got = [None] * self.world, {}, 0
        while got < self.world:
            try:
                rank, ok, payload = self._results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs) if not p.is_alive()]
                late = deadline is not None and time.monotonic() > deadline
                if dead or late:
                    self.close()
                    why = f"ranks {dead} exited" if dead else f"no result within {limit} s"
                    raise RuntimeError(f"{getattr(fn, '__name__', fn)} on {self.world} ranks: {why}") from None
                continue
            got += 1
            if ok:
                outs[rank] = _loads(payload)
            else:
                errors[rank] = payload
        if errors:
            self.close()
            first = min(errors)
            raise RuntimeError(f"{getattr(fn, '__name__', fn)} failed on ranks {sorted(errors)}; rank {first}:\n"
                               f"{errors[first]}")
        return outs

    def close(self) -> None:
        """Stop the ranks: ask each to leave, then kill what is left."""
        for q in self._tasks:
            try:
                q.put(None)
            except (OSError, ValueError):
                pass
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        self._procs = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def run_ranks(fn: Callable, world: int, *, device, args=(), backend: Optional[str] = None,
              timeout_s: float = DEFAULT_TIMEOUT_S):
    """``fn(*args)`` on ``world`` ranks; returns rank 0's result (on the CPU
    where the ranks were spawned). Under torchrun this process is one of the
    ranks: it joins the group (``env://``), runs ``fn`` and returns its own
    result; torchrun's world must be ``world``."""
    if under_torchrun():
        if int(os.environ["WORLD_SIZE"]) != world:
            raise ValueError(f"torchrun started {os.environ['WORLD_SIZE']} ranks; this run takes {world}")
        device = torch.device(device)
        _set_card(device, int(os.environ["LOCAL_RANK"]))
        dist.init_process_group(backend or backend_for(device), timeout=datetime.timedelta(seconds=timeout_s))
        try:
            return fn(*args)
        finally:
            _leave_group()
    with RankPool(world, device=device, backend=backend, timeout_s=timeout_s, quiet=True) as pool:
        return pool.run(fn, *args, timeout_s=None)[0]
