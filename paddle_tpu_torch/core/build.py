"""First-use native build of ``csrc/*.cpp`` into
``_lib/libpaddle_tpu_torch_native-<hash>.so`` (counterpart of
``paddle_tpu/core/build.py``).

Cached by a hash of the sources' content; rebuilds only when a source
changes.  The compile runs under a file lock named by that hash, so
ranks that start together on a fresh tree build the library once: the
first compiles, the others wait and load it.  ``_lib/`` is listed in ``.gitignore``, so a fresh checkout
builds it on the first call.  Returns None, with a warning when the
compiler failed, where no library can be had: the caller then takes its
python path, as the reference's do.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import warnings
from typing import Optional

from ..common.filelock import file_lock

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_SRC_DIR = os.path.join(os.path.dirname(__file__), "csrc")
_LIB_DIR = os.path.join(os.path.dirname(__file__), "_lib")


def _sources():
    return sorted(
        os.path.join(_SRC_DIR, f) for f in os.listdir(_SRC_DIR)
        if f.endswith(".cpp"))


def _digest(files) -> str:
    h = hashlib.sha256()
    for f in files:
        with open(f, "rb") as fp:
            h.update(fp.read())
    return h.hexdigest()[:16]


def load_native() -> Optional[ctypes.CDLL]:
    """Compile-once loader for the native runtime library."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        srcs = _sources()
        if not srcs:
            return None
        so = os.path.join(_LIB_DIR,
                          f"libpaddle_tpu_torch_native-{_digest(srcs)}.so")
        with file_lock(so + ".lock"):
            if not os.path.exists(so) and not _compile(srcs, so):
                return None
        try:
            _LIB = ctypes.CDLL(so)
        except OSError:
            return None
        _configure(_LIB)
        return _LIB


def _compile(srcs, so: str) -> bool:
    """``g++`` the sources into ``so`` (renamed into place when done);
    False, with a warning, where there is no compiler or it failed."""
    gxx = shutil.which("g++") or shutil.which("c++")
    if gxx is None:
        return False
    os.makedirs(_LIB_DIR, exist_ok=True)
    tmp = so + f".tmp{os.getpid()}"
    cmd = [gxx, "-O2", "-fPIC", "-shared", "-pthread", "-std=c++17",
           "-o", tmp] + srcs
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=240)
        os.replace(tmp, so)
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired) as e:
        err = getattr(e, "stderr", b"") or b""
        warnings.warn(f"native build failed, using python fallbacks: "
                      f"{err.decode(errors='replace')[-500:]}")
        return False
    return True


def _configure(lib: ctypes.CDLL):
    """The ``tcp_store_*`` and ``dataio_*`` symbols."""
    c = ctypes
    lib.tcp_store_server_start.restype = c.c_void_p
    lib.tcp_store_server_start.argtypes = [c.c_char_p, c.c_int,
                                           c.POINTER(c.c_int)]
    lib.tcp_store_server_stop.argtypes = [c.c_void_p]
    lib.tcp_store_connect.restype = c.c_int
    lib.tcp_store_connect.argtypes = [c.c_char_p, c.c_int, c.c_int]
    lib.tcp_store_close.argtypes = [c.c_int]
    lib.tcp_store_set.restype = c.c_int
    lib.tcp_store_set.argtypes = [c.c_int, c.c_char_p, c.c_int,
                                  c.c_char_p, c.c_uint64]
    lib.tcp_store_get.restype = c.c_int
    lib.tcp_store_get.argtypes = [c.c_int, c.c_char_p, c.c_int,
                                  c.c_uint64,
                                  c.POINTER(c.POINTER(c.c_char)),
                                  c.POINTER(c.c_uint64)]
    lib.tcp_store_add.restype = c.c_int
    lib.tcp_store_add.argtypes = [c.c_int, c.c_char_p, c.c_int,
                                  c.c_int64, c.POINTER(c.c_int64)]
    lib.tcp_store_wait.restype = c.c_int
    lib.tcp_store_wait.argtypes = [c.c_int, c.c_char_p, c.c_int,
                                   c.c_uint64]
    lib.tcp_store_delete.restype = c.c_int
    lib.tcp_store_delete.argtypes = [c.c_int, c.c_char_p, c.c_int]
    lib.tcp_store_check.restype = c.c_int
    lib.tcp_store_check.argtypes = [c.c_int, c.c_char_p, c.c_int,
                                    c.POINTER(c.c_int)]
    lib.tcp_store_free.argtypes = [c.POINTER(c.c_char)]
    lib.dataio_open.restype = c.c_void_p
    lib.dataio_open.argtypes = [c.c_char_p, c.c_int, c.c_int64, c.c_int64,
                                c.c_int, c.c_int64]
    lib.dataio_num_batches.restype = c.c_int64
    lib.dataio_num_batches.argtypes = [c.c_void_p]
    lib.dataio_num_seqs.restype = c.c_int64
    lib.dataio_num_seqs.argtypes = [c.c_void_p]
    lib.dataio_next.restype = c.c_int64
    lib.dataio_next.argtypes = [c.c_void_p, c.c_void_p]
    lib.dataio_close.argtypes = [c.c_void_p]
