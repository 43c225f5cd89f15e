"""The launcher's arguments (counterpart of
``paddle_tpu/distributed/launch/main.py``)."""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from .controller import Controller, LaunchConfig

__all__ = ["launch", "parse_args"]


def parse_args(argv: Optional[List[str]] = None) -> LaunchConfig:
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.distributed.launch",
        description="Launch a multi-process (multi-node) training job: "
                    "one trainer process a card.")
    p.add_argument("--nnodes", type=int, default=1,
                   help="number of nodes (hosts)")
    p.add_argument("--node_rank", type=int, default=0,
                   help="this node's index in [0, nnodes)")
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="trainer processes on this node (one a card)")
    p.add_argument("--master", type=str, default=None,
                   help="the store's host:port (required multi-node; node "
                        "0 hosts it)")
    p.add_argument("--log_dir", type=str, default=None,
                   help="per-worker log directory (workerlog.N)")
    p.add_argument("--elastic_level", type=int, default=0,
                   help="0: fail fast; 1: relaunch gang on worker failure")
    p.add_argument("--max_restarts", type=int, default=3)
    p.add_argument("--module", action="store_true",
                   help="run the script as a python module (python -m)")
    p.add_argument("script", help="training script")
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    a = p.parse_args(argv)
    if a.nnodes > 1 and not a.master:
        p.error("--master host:port is required when nnodes > 1")
    return LaunchConfig(
        script=a.script, script_args=a.script_args, nnodes=a.nnodes,
        node_rank=a.node_rank, nproc_per_node=a.nproc_per_node,
        master=a.master, log_dir=a.log_dir, elastic_level=a.elastic_level,
        max_restarts=a.max_restarts, module=a.module)


def launch(argv: Optional[List[str]] = None) -> int:
    return Controller(parse_args(argv)).run()


if __name__ == "__main__":
    sys.exit(launch())
