"""The distributed environment: ranks, the process group, spawn
(counterpart of ``paddle_tpu/distributed/env.py``).

Ranks come from the launch environment (``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM``, ``PADDLE_MASTER``, ``PADDLE_LOCAL_RANK``, set
by ``distributed.launch`` and ``spawn``).  One process drives one card:
``init_parallel_env`` joins the gang's ``torch.distributed`` process
group, NCCL on ``cuda:<local rank>`` by default, gloo on the CPU when
the caller passes ``device="cpu"``.  The rendezvous is the port's
``TCPStore`` on ``PADDLE_MASTER``, handed to c10d as its store.  The
process that starts the gang (the launch controller, ``spawn``) hosts
the store on a port it bound and says so with
``PADDLE_STORE_HOSTED=1``; without that, rank 0 hosts it, as Paddle's
own store does.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as _dist

from ..common.errors import enforce
from ..runtime.device import resolve_device
from .store import C10dStore, TCPStore

__all__ = ["init_parallel_env", "get_rank", "get_world_size",
           "get_local_rank", "get_store", "get_device", "ParallelEnv",
           "spawn", "MultiprocessContext", "split_master"]

_STORE: Optional[TCPStore] = None
# c10d holds only the C++ half of the store it was given: this reference
# keeps the python object (whose methods c10d calls) alive
_C10D_STORE: Optional[C10dStore] = None
_DEVICE: Optional[torch.device] = None
_TIMEOUT_S = 300.0


def split_master(master: str):
    host, _, port = master.rpartition(":")
    return host or "127.0.0.1", int(port)


def init_parallel_env(device=None, timeout: float = _TIMEOUT_S) -> bool:
    """Join the gang's process group (idempotent); True once it is up.

    ``device=None`` is the card of this rank's local rank (its process
    group on NCCL); without a CUDA device that raises, unless the
    caller passes ``device="cpu"`` (gloo).  Outside a launched gang
    (no ``PADDLE_TRAINERS_NUM``) it forms a world of one."""
    global _STORE, _C10D_STORE, _DEVICE
    if _dist.is_available() and _dist.is_initialized():
        return True
    rank, world = get_rank(), get_world_size()
    if device is None or str(device) == "cuda":
        resolve_device(None)            # raises where there is no card
        dev = torch.device("cuda", ParallelEnv().device_id)
    else:
        dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    master = os.environ.get("PADDLE_MASTER")
    if master:
        host, port = split_master(master)
        hosts = rank == 0 and os.environ.get("PADDLE_STORE_HOSTED") != "1"
        store = TCPStore(host, port, world, is_master=hosts,
                         timeout=timeout)
    else:
        enforce(world == 1, "PADDLE_MASTER is required when "
                            "PADDLE_TRAINERS_NUM > 1")
        store = TCPStore("127.0.0.1", 0, 1, is_master=True,
                         timeout=timeout)
    c10d_store = C10dStore(store)
    _dist.init_process_group(
        backend, store=c10d_store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout))
    _STORE, _C10D_STORE, _DEVICE = store, c10d_store, dev
    return True


def get_store() -> Optional[TCPStore]:
    """The store ``init_parallel_env`` rendezvoused through (None
    before it ran)."""
    return _STORE


def get_device() -> Optional[torch.device]:
    """This rank's device, as ``init_parallel_env`` resolved it."""
    return _DEVICE


def _reset():
    global _STORE, _C10D_STORE, _DEVICE
    if _STORE is not None:
        _STORE.close()
    _STORE = _C10D_STORE = _DEVICE = None


def get_rank() -> int:
    if _dist.is_available() and _dist.is_initialized():
        return _dist.get_rank()
    return int(os.environ.get("PADDLE_TRAINER_ID", "0"))


def get_world_size() -> int:
    if _dist.is_available() and _dist.is_initialized():
        return _dist.get_world_size()
    return int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))


def get_local_rank() -> int:
    """This process's rank on its node."""
    return int(os.environ.get("PADDLE_LOCAL_RANK",
                              os.environ.get("PADDLE_TRAINER_ID", "0")))


class ParallelEnv:
    """paddle.distributed.ParallelEnv: the launch environment's view of
    this rank."""

    @property
    def rank(self):
        return get_rank()

    @property
    def local_rank(self):
        return get_local_rank()

    @property
    def world_size(self):
        return get_world_size()

    nranks = world_size

    @property
    def device_id(self):
        """The card this rank drives: ``FLAGS_selected_gpus`` where
        set, else the local rank."""
        sel = os.environ.get("FLAGS_selected_gpus")
        return int(sel.split(",")[0]) if sel else get_local_rank()

    @property
    def current_endpoint(self):
        eps = self.trainer_endpoints
        r = get_rank()
        return eps[r] if r < len(eps) else ""

    @property
    def trainer_endpoints(self):
        return [e for e in os.environ.get(
            "PADDLE_TRAINER_ENDPOINTS", "").split(",") if e]


def _spawn_worker(fn, rank, nprocs, master, args):
    os.environ.update({"PADDLE_TRAINER_ID": str(rank),
                       "PADDLE_TRAINERS_NUM": str(nprocs),
                       "PADDLE_LOCAL_RANK": str(rank),
                       "PADDLE_MASTER": master,
                       "PADDLE_STORE_HOSTED": "1"})
    fn(*args)


def spawn(func, args=(), nprocs=1, join=True, daemon=False, **options):
    """paddle.distributed.spawn: run ``func(*args)`` in ``nprocs``
    processes (the spawn start method: fresh interpreters) with the
    launch environment set.  The parent hosts the store on a port it
    bound, so no port is picked and then raced for; each worker's
    ``init_parallel_env`` joins through it.  ``func`` must be
    importable by the children (a module-level function)."""
    import multiprocessing as mp

    if nprocs <= 1:
        func(*args)
        return None
    host = options.get("host", "127.0.0.1")
    store = TCPStore(host, 0, nprocs, is_master=True)
    master = f"{host}:{store.port}"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_spawn_worker,
                         args=(func, r, nprocs, master, args),
                         daemon=daemon)
             for r in range(nprocs)]
    for p in procs:
        p.start()
    ctx_obj = MultiprocessContext(procs, store)
    if join:
        ctx_obj.join()
        return None
    return ctx_obj


class MultiprocessContext:
    """``spawn(join=False)``'s result: ``.join()`` raises on a worker's
    failure or a worker still running after the timeout;
    ``.processes``."""

    def __init__(self, processes, store=None):
        self.processes = list(processes)
        self._store = store

    def join(self, timeout=None):
        for p in self.processes:
            p.join(timeout)
        hung = [p.pid for p in self.processes if p.is_alive()]
        if hung:
            raise RuntimeError(
                f"spawn worker(s) still alive after join"
                f"(timeout={timeout}): pids {hung}")
        if self._store is not None:
            self._store.close()
            self._store = None
        bad = [p.exitcode for p in self.processes if p.exitcode]
        if bad:
            raise RuntimeError(f"spawn worker(s) failed: {bad}")
        return True

