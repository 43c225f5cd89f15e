"""Build and load the port's CUDA kernels.

Each source ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into its own shared library
with a plain C interface, loaded with ``ctypes``.  The library lands in
``csrc/build/`` (listed in ``.gitignore``) under a name that carries a
hash of the sources, so an edited kernel rebuilds and an unchanged one
loads as it is.  Nothing is built when the package is imported: the
first kernel call on a CUDA tensor builds what it needs, and
``build()`` builds several sources at once, one ``nvcc`` process each,
all started together.  The compiles run under one file lock a library
(named by its hash), taken in a fixed order, so ranks that start
together on a fresh tree build each library once: the first compiles,
the others wait and load it.  The assembler's register/spill report of each
build is kept beside its library, so a cached build reports it too.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

from ..common.filelock import file_lock

__all__ = ["build", "load", "CSRC", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the GPU (CUDA toolkit on PATH or "
                       "under /usr/local/cuda)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(ARCH_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _report_path(name: str) -> Path:
    return _lib_path(name).with_suffix(".ptxas")


def build(names: Iterable[str]) -> Dict[str, dict]:
    """Compile the named sources that are not built yet, all in
    parallel.  Returns {name: {"seconds", "ptxas"}} for every source
    named: ``ptxas`` is the assembler's register/spill report of its
    build, ``seconds`` its build time here (None when it was built
    before).  Raises with the compiler's output if any fails."""
    names = list(names)
    report = {n: {"seconds": None, "ptxas": _report_path(n).read_text()}
              for n in names
              if _lib_path(n).exists() and _report_path(n).exists()}
    todo = sorted(n for n in names if n not in report)
    if not todo:
        return report
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with contextlib.ExitStack() as locks:
        for name in todo:
            locks.enter_context(file_lock(str(_lib_path(name)) + ".lock"))
        # another process may have built them while this one waited
        for name in todo:
            if _lib_path(name).exists() and _report_path(name).exists():
                report[name] = {"seconds": None,
                                "ptxas": _report_path(name).read_text()}
        _compile([n for n in todo if n not in report], report)
    return report


def _compile(todo, report) -> None:
    """One ``nvcc`` a source, all started together; fills ``report``."""
    if not todo:
        return
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-lineinfo",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode})\n{out}")
            os.unlink(tmp)
            continue
        _report_path(name).write_text(out)
        os.replace(tmp, _lib_path(name))
        report[name] = {"seconds": time.perf_counter() - t0, "ptxas": out}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _loaded[name] = lib
        return lib
