"""An inter-process lock on a file (``fcntl.flock``), for first-use
builds: N ranks that start together on a fresh tree must compile a
library once, with the others waiting and then loading what the first
built, rather than each running the compiler at the same time."""
from __future__ import annotations

import contextlib
import fcntl
import os

__all__ = ["file_lock"]


@contextlib.contextmanager
def file_lock(path: str):
    """Hold an exclusive lock on ``path`` (created if missing) for the
    body of the ``with``; other processes that ask for the same path
    wait.  The lock goes with the file descriptor, so a process that
    dies releases it."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)
