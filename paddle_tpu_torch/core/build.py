"""First-use native build of ``csrc/*.cpp`` into
``_lib/libpaddle_tpu_torch_native-<hash>.so`` (counterpart of
``paddle_tpu/core/build.py``).

Cached by a hash of the sources' content; rebuilds only when a source
changes.  ``_lib/`` is listed in ``.gitignore``, so a fresh checkout
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
        if not os.path.exists(so):
            gxx = shutil.which("g++") or shutil.which("c++")
            if gxx is None:
                return None
            os.makedirs(_LIB_DIR, exist_ok=True)
            tmp = so + f".tmp{os.getpid()}"
            cmd = [gxx, "-O2", "-fPIC", "-shared", "-pthread",
                   "-std=c++17", "-o", tmp] + srcs
            try:
                subprocess.run(cmd, check=True, capture_output=True,
                               timeout=240)
                os.replace(tmp, so)   # atomic: concurrent builds race safely
            except (subprocess.CalledProcessError,
                    subprocess.TimeoutExpired) as e:
                err = getattr(e, "stderr", b"") or b""
                warnings.warn(
                    f"native build failed, using python fallbacks: "
                    f"{err.decode(errors='replace')[-500:]}")
                return None
        try:
            _LIB = ctypes.CDLL(so)
        except OSError:
            return None
        _configure(_LIB)
        return _LIB


def _configure(lib: ctypes.CDLL):
    """The ``dataio_*`` symbols (the reference binds its store's too)."""
    c = ctypes
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
