"""The launch controller (counterpart of
``paddle_tpu/distributed/launch/controller.py``).

It starts ``--nproc_per_node`` trainer processes on this node with the
launch environment (``PADDLE_MASTER``, ``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM``, ``PADDLE_LOCAL_RANK``, ...), streams each
worker's output to ``--log_dir/workerlog.<rank>``, and supervises the
gang: fail fast (the first non-zero exit code ends the gang and is the
launcher's), or at ``--elastic_level 1`` relaunch the whole gang on a
failure, up to ``--max_restarts`` times (recovery is the trainer's: it
reloads its latest checkpoint).

The rendezvous store (``distributed.TCPStore``) is hosted here, on node
0: bound to port 0 when no ``--master`` is given, then handed on in
``PADDLE_MASTER``, so no port is picked and then raced for; a relaunch
starts a fresh store.  ``PADDLE_STORE_HOSTED=1`` tells the workers that
rank 0 need not host one.  A host with only a loopback interface gets
``NCCL_SOCKET_IFNAME=lo`` where it is unset.
"""
from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

__all__ = ["LaunchConfig", "Controller", "free_port"]


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _only_loopback() -> bool:
    try:
        names = [n for _, n in socket.if_nameindex()]
    except OSError:
        return False
    return all(n == "lo" for n in names)


@dataclass
class LaunchConfig:
    script: str = ""
    script_args: List[str] = field(default_factory=list)
    nnodes: int = 1
    node_rank: int = 0
    nproc_per_node: int = 1
    master: Optional[str] = None      # "host:port"; default: node 0 binds
    log_dir: Optional[str] = None
    elastic_level: int = 0            # 0: fail fast; 1: relaunch gang
    max_restarts: int = 3
    env: Dict[str, str] = field(default_factory=dict)
    module: bool = False              # run script with -m


class Controller:
    """Spawns and supervises the local trainer gang."""

    def __init__(self, cfg: LaunchConfig):
        self.cfg = cfg
        self._given_master = cfg.master
        self._store = None
        self.procs: List[subprocess.Popen] = []
        self._logs = []

    # -- the store ---------------------------------------------------------------
    def _host_store(self):
        """Node 0 hosts a fresh store: on ``--master``'s port, or on one
        it binds."""
        if self.cfg.node_rank != 0:
            return
        from ..env import split_master
        from ..store import TCPStore
        if self._store is not None:
            self._store.close()
        n = self.cfg.nnodes * self.cfg.nproc_per_node
        if self._given_master:
            host, port = split_master(self._given_master)
            self._store = TCPStore(host, port, n, is_master=True)
        else:
            self._store = TCPStore("127.0.0.1", 0, n, is_master=True)
            self.cfg.master = f"127.0.0.1:{self._store.port}"

    # -- env per worker ------------------------------------------------------
    def _worker_env(self, local_rank: int) -> Dict[str, str]:
        cfg = self.cfg
        rank = cfg.node_rank * cfg.nproc_per_node + local_rank
        env = dict(os.environ)
        env.update(cfg.env)
        env.update({
            "PADDLE_MASTER": cfg.master,
            "PADDLE_STORE_HOSTED": "1",
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(cfg.nnodes * cfg.nproc_per_node),
            "PADDLE_LOCAL_RANK": str(local_rank),
            "PADDLE_LOCAL_SIZE": str(cfg.nproc_per_node),
            "PADDLE_NNODES": str(cfg.nnodes),
            # the rendezvous must not route through a proxy
            "NO_PROXY": env.get("NO_PROXY", "") + ",127.0.0.1,localhost",
            "no_proxy": env.get("no_proxy", "") + ",127.0.0.1,localhost",
        })
        if "NCCL_SOCKET_IFNAME" not in env and _only_loopback():
            env["NCCL_SOCKET_IFNAME"] = "lo"
        return env

    # -- lifecycle -----------------------------------------------------------
    def _spawn_one(self, local_rank: int) -> subprocess.Popen:
        cfg = self.cfg
        cmd = [sys.executable]
        if cfg.module:
            cmd += ["-m", cfg.script]
        else:
            cmd += [cfg.script]
        cmd += list(cfg.script_args)
        stdout = stderr = None
        if cfg.log_dir:
            os.makedirs(cfg.log_dir, exist_ok=True)
            rank = cfg.node_rank * cfg.nproc_per_node + local_rank
            f = open(os.path.join(cfg.log_dir, f"workerlog.{rank}"), "ab")
            self._logs.append(f)
            stdout, stderr = f, subprocess.STDOUT
        return subprocess.Popen(cmd, env=self._worker_env(local_rank),
                                stdout=stdout, stderr=stderr)

    def start(self):
        self._host_store()
        self.procs = [self._spawn_one(i)
                      for i in range(self.cfg.nproc_per_node)]

    def stop(self, sig=signal.SIGTERM):
        for p in self.procs:
            if p.poll() is None:
                try:
                    p.send_signal(sig)
                except OSError:
                    pass
        deadline = time.time() + 10
        for p in self.procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for f in self._logs:
            f.close()
        self._logs = []

    def _poll_gang(self) -> Optional[int]:
        """None while all running; else first non-zero exit code, or 0
        when every worker exited cleanly."""
        codes = [p.poll() for p in self.procs]
        for c in codes:
            if c is not None and c != 0:
                return c
        if all(c == 0 for c in codes):
            return 0
        return None

    def run(self) -> int:
        """Supervise until the gang exits.  Elastic level 1: on a worker's
        failure stop and relaunch the whole gang (a fresh store: ranks
        rendezvous anew) up to max_restarts times."""
        restarts = 0
        try:
            self.start()
            while True:
                code = self._poll_gang()
                if code is None:
                    time.sleep(0.2)
                    continue
                if code == 0:
                    self.stop()
                    return 0
                if self.cfg.elastic_level >= 1 and \
                        restarts < self.cfg.max_restarts:
                    restarts += 1
                    sys.stderr.write(
                        f"[launch] worker failed (exit {code}); "
                        f"relaunching gang (restart {restarts}/"
                        f"{self.cfg.max_restarts})\n")
                    self.stop()
                    self.start()
                    continue
                self.stop()
                return code
        finally:
            self.stop(signal.SIGKILL)
            if self._store is not None:
                self._store.close()
                self._store = None
