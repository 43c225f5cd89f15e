"""Train-state checkpoints with atomic commit and sha256-verified loads
(counterpart of ``paddle_tpu/distributed/checkpoint.py``).

The on-disk format is the reference's: a directory of ``.npy`` chunk
files plus ``metadata.json``, which records each array's global shape,
dtype name, the index box every chunk covers with the chunk's sha256 and
byte count, the JSON literals (python ints, floats, bools, strings and
None) and ``"committed": true``.  Either package reads what the other
wrote.  Extension dtypes (bfloat16, the float8 types) are stored as raw
void records of their width, as numpy writes them; the port reads and
writes them as their 8- or 16-bit pattern viewed as the torch dtype, so
it needs no ``ml_dtypes``.  ``load_state_dict`` assembles an array from
whatever chunk layout the manifest describes, so a checkpoint the
reference wrote sharded over several devices loads whole.

Sharded state (a ``ShardedArray`` leaf: this rank's part of a global
array, with its index box) is saved as the reference saves a sharded
``jax.Array``: the manifest lists every part's box, and each part is
written by the one rank that holds its first replica.  In a gang
(``torch.distributed`` up with more than one rank) a save is collective:
the coordinator draws the save's nonce and hands it on through the
gang's store, every rank writes its own parts into the shared staging
directory and posts their digests to the store, and the coordinator
waits for all of them, writes the manifest and commits; the others
return once the commit is posted.  A replicated tensor is written by
the coordinator alone.  Loading reads each template leaf's own box from
whatever parts cover it, so a checkpoint reloads onto another world
size (another set of boxes).

Crash safety (the reference's atomic-commit contract):

- Every save builds the whole checkpoint in a ``<path>.tmp-<nonce>``
  staging directory next to the destination: chunk files (fsync'd),
  then the manifest with ``"committed": true`` and per-chunk sha256.
- Fresh destination: commit is one ``os.rename(staging, path)``; a kill
  at any byte offset leaves either no ``path`` (plus an orphaned staging
  dir that later saves and ``CheckpointManager.gc_stale`` sweep) or the
  complete checkpoint.
- Existing destination (re-save in place): the fresh ``data-<nonce>``
  chunk dir is renamed into ``path`` first, then the manifest is
  atomically replaced; readers see the old checkpoint until the swap.
- Load verifies each chunk's size and sha256 against the manifest and
  raises :class:`CorruptCheckpointError` on any mismatch or missing
  file, before the template is changed at all.

Snapshots: the port's train state is updated in place, so every save
copies each tensor leaf to host memory the writer owns before it
returns (CUDA leaves once each, into pinned buffers, then one wait on
their streams); with ``async_save=True`` only the disk writes run on a
background thread.  Its failure re-raises on ``wait()`` and, if never
waited, at the next ``save_state_dict``; live writers are joined at
interpreter exit.
"""
from __future__ import annotations

import atexit
import hashlib
import io as _io
import json
import os
import re
import shutil
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..common.errors import CorruptCheckpointError, enforce

__all__ = ["save_state_dict", "load_state_dict", "get_checkpoint_metadata",
           "validate_checkpoint", "AsyncSaveHandle", "CorruptCheckpointError",
           "ChaosCrash", "set_chaos", "clear_chaos", "ShardedArray"]

_METADATA = "metadata.json"
_VERSION = 2                 # v2: "committed" flag + per-chunk sha256/bytes
_KNOWN_VERSIONS = (1, 2)     # v1 (pre-atomic) checkpoints still load

# dtype names of the manifest (numpy's, as ``str(array.dtype)`` gives
# them) for each torch dtype; the extension dtypes ride as raw records
_NAMES = {torch.float32: "float32", torch.float64: "float64",
          torch.float16: "float16", torch.bfloat16: "bfloat16",
          torch.int8: "int8", torch.uint8: "uint8", torch.int16: "int16",
          torch.int32: "int32", torch.int64: "int64", torch.bool: "bool",
          torch.complex64: "complex64", torch.complex128: "complex128"}
for _name in ("float8_e4m3fn", "float8_e5m2"):
    if hasattr(torch, _name):
        _NAMES[getattr(torch, _name)] = _name
_EXTENSION = {"bfloat16": (torch.bfloat16, np.int16)}
for _name in ("float8_e4m3fn", "float8_e5m2"):
    if hasattr(torch, _name):
        _EXTENSION[_name] = (getattr(torch, _name), np.int8)


# ---------------------------------------------------------------------------
# chaos injection (crash-at-point, for the crash tests)
# ---------------------------------------------------------------------------

class ChaosCrash(RuntimeError):
    """In-process stand-in for a SIGKILL at a save point."""


_CHAOS_ENV = "PADDLE_TPU_TORCH_CKPT_CHAOS"
_CHAOS_POINTS = ("mid-chunk", "pre-manifest", "pre-rename", "post-commit")
_chaos_plan: Optional[Dict[str, Any]] = None


def set_chaos(point: str, nth: int = 1, mode: str = "raise"):
    """Arm a crash at the given save point on its ``nth`` visit.
    ``mode="raise"`` raises :class:`ChaosCrash`; ``mode="exit"`` calls
    ``os._exit(17)``.  The environment variable
    ``PADDLE_TPU_TORCH_CKPT_CHAOS=point[:nth[:mode]]`` arms the same plan
    across a process boundary."""
    global _chaos_plan
    enforce(point in _CHAOS_POINTS, f"unknown chaos point {point!r}; "
            f"one of {_CHAOS_POINTS}")
    _chaos_plan = {"point": point, "n": int(nth), "mode": mode}


def clear_chaos():
    global _chaos_plan
    _chaos_plan = None
    os.environ.pop(_CHAOS_ENV, None)


def _chaos_spec() -> Optional[Dict[str, Any]]:
    global _chaos_plan
    if _chaos_plan is None:
        env = os.environ.get(_CHAOS_ENV)
        if env:
            parts = env.split(":")
            _chaos_plan = {"point": parts[0],
                           "n": int(parts[1]) if len(parts) > 1 else 1,
                           "mode": parts[2] if len(parts) > 2 else "exit"}
    return _chaos_plan


def _chaos_hit(point: str) -> bool:
    plan = _chaos_spec()
    if plan is None or plan["point"] != point:
        return False
    plan["n"] -= 1
    return plan["n"] <= 0


def _chaos_crash(point: str):
    plan = _chaos_spec()
    mode = plan["mode"] if plan else "raise"
    clear_chaos()
    if mode == "exit":
        os._exit(17)
    raise ChaosCrash(f"injected crash at checkpoint save point {point!r}")


# ---------------------------------------------------------------------------
# staging-dir registry + fsync helpers
# ---------------------------------------------------------------------------

_STAGING_LOCK = threading.Lock()
_LIVE_STAGING: Set[str] = set()


def _track_staging(p: str):
    with _STAGING_LOCK:
        _LIVE_STAGING.add(p)


def _untrack_staging(p: str):
    with _STAGING_LOCK:
        _LIVE_STAGING.discard(p)


def staging_dirs_alive() -> List[str]:
    """Staging dirs created but never committed or swept that still
    exist on disk."""
    with _STAGING_LOCK:
        return sorted(p for p in _LIVE_STAGING if os.path.isdir(p))


def _fsync_dir(d: str):
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _npy_bytes(arr: np.ndarray) -> bytes:
    buf = _io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _reg():
    from ..observability import get_registry
    return get_registry()


_SECONDS_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                    30.0, 60.0, 300.0)


def _save_metrics():
    reg = _reg()
    return (reg.histogram("ckpt_save_seconds",
                          "checkpoint save duration (host->disk flush)",
                          labelnames=("mode",), buckets=_SECONDS_BUCKETS),
            reg.counter("ckpt_bytes_written_total",
                        "checkpoint chunk+manifest bytes flushed to disk"))


def _load_metrics():
    return _reg().histogram("ckpt_load_seconds",
                            "checkpoint load duration (disk->device)",
                            buckets=_SECONDS_BUCKETS)


# ---------------------------------------------------------------------------
# async save handles: failures surface, never vanish
# ---------------------------------------------------------------------------

class AsyncSaveHandle:
    """Returned by ``save_state_dict(async_save=True)``.

    ``wait(timeout=None)`` joins the background writer and re-raises its
    exception, if any.  ``join`` is an alias.  A handle whose writer
    failed and was never waited re-raises at the next
    ``save_state_dict``; live writers are joined at interpreter exit."""

    def __init__(self, path: str):
        self.path = path
        self.bytes_written = 0
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None
        self._surfaced = False

    def done(self) -> bool:
        return self._thread is not None and not self._thread.is_alive()

    def exception(self) -> Optional[BaseException]:
        """The writer's exception (marks it surfaced), or None."""
        if self._exc is not None:
            self._surfaced = True
        return self._exc

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Join the writer.  Returns False on timeout; raises the
        writer's exception when the save failed."""
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                return False
        _forget_handle(self)
        if self._exc is not None:
            self._surfaced = True
            raise self._exc
        return True

    def join(self, timeout: Optional[float] = None):
        self.wait(timeout)


_HANDLES_LOCK = threading.Lock()
_LIVE_HANDLES: Set[AsyncSaveHandle] = set()
_ATEXIT_ARMED = False


def _remember_handle(h: AsyncSaveHandle):
    global _ATEXIT_ARMED
    with _HANDLES_LOCK:
        _LIVE_HANDLES.add(h)
        if not _ATEXIT_ARMED:
            _ATEXIT_ARMED = True
            atexit.register(_join_live_writers)


def _forget_handle(h: AsyncSaveHandle):
    with _HANDLES_LOCK:
        _LIVE_HANDLES.discard(h)


def _surface_failed_async_saves():
    """At every save entry: a finished, failed handle nobody waited on
    re-raises here rather than vanishing with its thread."""
    with _HANDLES_LOCK:
        handles = list(_LIVE_HANDLES)
    for h in handles:
        if not h.done():
            continue
        _forget_handle(h)
        if h._exc is not None and not h._surfaced:
            h._surfaced = True
            raise RuntimeError(
                f"previous async checkpoint save to {h.path!r} failed "
                f"(surfacing at next save; call handle.wait() to catch "
                f"it at the save site)") from h._exc


def _join_live_writers():
    """atexit: never let the interpreter tear down under an in-flight
    checkpoint writer."""
    with _HANDLES_LOCK:
        handles = list(_LIVE_HANDLES)
    for h in handles:
        if h._thread is not None:
            h._thread.join(timeout=600.0)
        if h._exc is not None and not h._surfaced:
            print(f"paddle_tpu_torch: async checkpoint save to {h.path!r} "
                  f"failed and was never waited on: {h._exc!r}",
                  file=sys.stderr)


# ---------------------------------------------------------------------------
# tree <-> flat {path: leaf}
# ---------------------------------------------------------------------------

def _flatten(tree, prefix="") -> Dict[str, Any]:
    """Flatten nested dict/list/tuple into {"a/b/0": leaf}; tensors and
    arrays are leaves."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            enforce("/" not in str(k), f"state key {k!r} may not contain '/'")
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1] if prefix else ""] = tree
    return out


def _set_in(tree, path: str, value):
    """Put a loaded value at ``path``: into a template tensor in place
    (its identity kept: parameters and slots stay the model's), else in
    the container."""
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node[p] if isinstance(node, dict) else node[int(p)]
    last = parts[-1]
    if isinstance(node, dict):
        old = node.get(last)
    else:
        last = int(last)
        old = node[last]
    if isinstance(old, torch.Tensor):
        with torch.no_grad():
            old.copy_(value)
    elif isinstance(old, ShardedArray):
        with torch.no_grad():
            old.local.copy_(value)
    elif isinstance(node, (dict, list)):
        node[last] = value
    else:
        raise TypeError(f"cannot assign into tuple at {path!r}; use lists "
                        "or dicts in checkpointable state")


def _is_array(x) -> bool:
    # python int/float/bool/str round-trip as JSON literals; numpy
    # scalars count as 0-d arrays
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic,
                          ShardedArray))


def _fname(key: str, box: Sequence[Tuple[int, int]]) -> str:
    # readable prefix + short key hash: sanitizing '/'->'_' alone is not
    # injective ('a/b_c' vs 'a_b/c'), the hash keeps names collision-free
    safe = re.sub(r"[^A-Za-z0-9_.-]", "_", key)[-80:]
    h = hashlib.md5(key.encode()).hexdigest()[:8]
    tag = "-".join(f"{a}_{b}" for a, b in box) if box else "scalar"
    return f"{safe}.{h}.{tag}.npy"


def _whole_box(shape) -> Tuple[Tuple[int, int], ...]:
    return tuple((0, int(d)) for d in shape)


class ShardedArray:
    """This rank's part of a global array, as a checkpoint leaf: the
    ``local`` tensor covers ``box`` of an array of ``global_shape``,
    which is cut into ``boxes`` (every part's box, the same list on
    every rank); ``write`` says whether this rank writes its part (it
    holds the part's first replica).  Loading fills ``local`` in place
    from the checkpoint's chunks over ``box``."""

    def __init__(self, local: torch.Tensor, global_shape, box, boxes,
                 write: bool = True):
        self.local = local
        self.global_shape = tuple(int(d) for d in global_shape)
        self.box = tuple(tuple(int(x) for x in b) for b in box)
        self.boxes = [tuple(tuple(int(x) for x in b) for b in bx)
                      for bx in boxes]
        self.write = bool(write)
        enforce(tuple(local.shape) == tuple(b - a for a, b in self.box),
                f"ShardedArray: local shape {tuple(local.shape)} does not "
                f"fill its box {self.box}")

    @property
    def dtype(self):
        return self.local.dtype


def _gang():
    """(rank, world) of the gang a save or load runs in: (0, 1) outside
    a ``torch.distributed`` world of more than one rank."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _gang_store():
    """A connection to the gang's store of its own (an async writer's
    blocking waits must not queue behind the trainer's)."""
    from . import env
    store = env.get_store()
    if store is not None:
        return store.client()
    import torch.distributed as dist
    return dist.distributed_c10d._get_default_store()


def _store_get(store, key: str, timeout_s: float = 600.0) -> bytes:
    from .store import TCPStore
    if isinstance(store, TCPStore):
        return store.get(key, timeout_ms=int(timeout_s * 1000))
    return store.get(key)


_SAVE_SEQ = [0]


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        enforce(leaf.dtype in _NAMES,
                f"checkpoints take no {leaf.dtype} tensors")
        return _NAMES[leaf.dtype]
    return str(leaf.dtype)


def _host_numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor as the numpy array its chunk file holds: extension
    dtypes as raw void records of their width."""
    name = _NAMES[t.dtype]
    if name in _EXTENSION:
        bits = _EXTENSION[name][1]
        return t.view(getattr(torch, np.dtype(bits).name)).numpy().view(
            np.dtype(f"V{np.dtype(bits).itemsize}"))
    return t.numpy()


def _snapshot(leaves: Dict[str, Any], owned: bool) -> Dict[str, np.ndarray]:
    """Every array leaf as a host numpy array: CUDA tensors copied once
    into pinned buffers (all launched, then one wait a device), CPU
    tensors and numpy arrays copied when ``owned`` (an async writer
    must not see later in-place updates)."""
    host: Dict[str, Any] = {}
    devices = set()
    with torch.no_grad():
        for key, leaf in leaves.items():
            if isinstance(leaf, torch.Tensor):
                t = leaf.detach()
                if t.is_cuda:
                    buf = torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=True)
                    buf.copy_(t, non_blocking=True)
                    devices.add(t.device)
                    host[key] = buf
                else:
                    t = t.contiguous()
                    host[key] = t.clone() if owned else t
            else:
                host[key] = np.array(leaf, copy=True) if owned \
                    else np.asarray(leaf)
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()
    return {k: _host_numpy(v) if isinstance(v, torch.Tensor) else v
            for k, v in host.items()}


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------

def save_state_dict(state_dict, path: str, process_group=None,
                    coordinator_rank: int = 0, async_save: bool = False
                    ) -> Optional[AsyncSaveHandle]:
    """Write ``state_dict`` (any tree of dicts and lists over tensors on
    any device, ``ShardedArray`` parts, numpy arrays, scalars and JSON
    literals) as a checkpoint directory at ``path``.

    Every tensor leaf is copied to host memory before this returns, so
    the caller may update the state in place at once.  With
    ``async_save=True`` the disk writes run on a background thread and
    an :class:`AsyncSaveHandle` is returned; a writer failure re-raises
    on ``handle.wait()`` or, unwaited, at the next save.  The commit is
    atomic (module docstring); orphaned staging dirs of killed saves are
    swept by the next successful save to the same path.  In a gang every
    rank calls this, in one order, with the same ``path``; the
    coordinator commits."""
    _surface_failed_async_saves()
    rank, nproc = _gang()
    store = None
    if nproc > 1:
        # the save's nonce, drawn by the coordinator and handed on
        # through the store (the gang's saves are numbered alike)
        store = _gang_store()
        _SAVE_SEQ[0] += 1
        tag = f"paddle_ckpt/{_SAVE_SEQ[0]}"
        if rank == coordinator_rank:
            nonce = format(int.from_bytes(os.urandom(4), "little"), "08x")
            store.set(f"{tag}/nonce", nonce.encode())
        else:
            nonce = _store_get(store, f"{tag}/nonce").decode()
    else:
        nonce = format(int.from_bytes(os.urandom(4), "little"), "08x")
    coordinator = rank == coordinator_rank
    path = path.rstrip("/")
    parent = os.path.dirname(path) or "."
    os.makedirs(parent, exist_ok=True)
    in_place = os.path.isdir(path)
    staging = f"{path}.tmp-{nonce}"
    data_dir = f"data-{nonce}"

    flat = _flatten(state_dict)
    manifest: Dict[str, Any] = {"version": _VERSION, "committed": True,
                                "arrays": {}, "literals": {},
                                "data_dir": data_dir}
    arrays: Dict[str, Any] = {}
    files: Dict[str, str] = {}
    for key, leaf in flat.items():
        if not _is_array(leaf):
            enforce(leaf is None or isinstance(leaf, (str, int, float, bool)),
                    f"unsupported checkpoint leaf at {key!r}: {type(leaf)}")
            manifest["literals"][key] = leaf
            continue
        if isinstance(leaf, ShardedArray):
            shape, boxes = leaf.global_shape, leaf.boxes
            mine, own = leaf.box, leaf.write
            value = leaf.local
        else:
            shape = tuple(leaf.shape)
            boxes = [_whole_box(shape)]
            mine, own, value = boxes[0], coordinator, leaf
        manifest["arrays"][key] = {
            "global_shape": list(shape), "dtype": _dtype_name(value),
            "chunks": [{"file": f"{data_dir}/{_fname(key, b)}",
                        "box": [list(x) for x in b]} for b in boxes]}
        if own:
            arrays[key] = value
            files[key] = f"{data_dir}/{_fname(key, mine)}"
    host = _snapshot(arrays, owned=async_save)
    writes = [(files[k], a) for k, a in host.items()]
    os.makedirs(os.path.join(staging, data_dir), exist_ok=True)
    _track_staging(staging)

    handle = AsyncSaveHandle(path) if async_save else None
    mode = "async" if async_save else "sync"

    def flush():
        t0 = time.monotonic()
        total_bytes = 0
        digests: Dict[str, Dict[str, Any]] = {}
        # chaos points count saves (not chunks): a mid-chunk hit tears
        # the first chunk at half its bytes and dies there
        torn_save = _chaos_hit("mid-chunk")
        for i, (rel, arr) in enumerate(writes):
            data = _npy_bytes(arr)
            if torn_save and i == 0:
                data = data[:max(1, len(data) // 2)]
            fpath = os.path.join(staging, rel)
            with open(fpath, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            if torn_save and i == 0:
                _chaos_crash("mid-chunk")
            digests[rel] = {"sha256": hashlib.sha256(data).hexdigest(),
                            "bytes": len(data)}
            total_bytes += len(data)
        if torn_save and not writes:
            _chaos_crash("mid-chunk")
        _fsync_dir(os.path.join(staging, data_dir))
        if _chaos_hit("pre-manifest"):
            _chaos_crash("pre-manifest")

        if nproc > 1:
            # each rank posts its chunks' digests; the coordinator waits
            # for every rank's, then writes the manifest and commits
            store.set(f"{tag}/done/{rank}", json.dumps(digests).encode())
            if not coordinator:
                _untrack_staging(staging)
                _store_get(store, f"{tag}/committed")
                return
            for r in range(nproc):
                if r != rank:
                    digests.update(json.loads(
                        _store_get(store, f"{tag}/done/{r}").decode()))

        # per-chunk integrity, then the committed manifest, written only
        # after every chunk is flushed
        for entry in manifest["arrays"].values():
            for chunk in entry["chunks"]:
                chunk.update(digests[chunk["file"]])
        mdata = json.dumps(manifest, indent=1).encode()
        with open(os.path.join(staging, _METADATA), "wb") as f:
            f.write(mdata)
            f.flush()
            os.fsync(f.fileno())
        total_bytes += len(mdata)
        _fsync_dir(staging)
        if _chaos_hit("pre-rename"):
            _chaos_crash("pre-rename")

        # commit
        if in_place:
            # readers see the old manifest (the complete old checkpoint)
            # until the manifest replace lands
            os.rename(os.path.join(staging, data_dir),
                      os.path.join(path, data_dir))
            tmp = os.path.join(path, _METADATA + f".tmp-{nonce}")
            os.rename(os.path.join(staging, _METADATA), tmp)
            os.replace(tmp, os.path.join(path, _METADATA))
            _fsync_dir(path)
            shutil.rmtree(staging, ignore_errors=True)
        else:
            os.rename(staging, path)
            _fsync_dir(parent)
        _untrack_staging(staging)
        if nproc > 1:
            store.set(f"{tag}/committed", b"1")
        if _chaos_hit("post-commit"):
            _chaos_crash("post-commit")

        # GC, only after the commit point: data dirs of older or
        # interrupted in-place saves, a manifest tmp left between the two
        # commit renames, orphaned sibling staging dirs of killed saves
        for entry in os.listdir(path):
            full = os.path.join(path, entry)
            if entry.startswith("data-") and entry != data_dir:
                shutil.rmtree(full, ignore_errors=True)
            elif entry.startswith(_METADATA + ".tmp-"):
                try:
                    os.remove(full)
                except OSError:
                    pass
        base = os.path.basename(path)
        for entry in os.listdir(parent):
            if entry.startswith(base + ".tmp-"):
                full = os.path.join(parent, entry)
                if full != staging and os.path.isdir(full):
                    shutil.rmtree(full, ignore_errors=True)
                    _untrack_staging(full)

        hist, bytes_ctr = _save_metrics()
        hist.labels(mode).observe(time.monotonic() - t0)
        bytes_ctr.inc(total_bytes)
        if handle is not None:
            handle.bytes_written = total_bytes

    if async_save:
        def run():
            try:
                flush()
            except BaseException as e:   # surfaced via handle/next save
                handle._exc = e

        t = threading.Thread(target=run, daemon=False,
                             name="paddle-tpu-torch-ckpt-writer")
        handle._thread = t
        _remember_handle(handle)
        t.start()
        return handle
    flush()
    return None


# ---------------------------------------------------------------------------
# load + validation
# ---------------------------------------------------------------------------

def get_checkpoint_metadata(path: str) -> Dict[str, Any]:
    """Parse and sanity-check the manifest.  Raises
    :class:`CorruptCheckpointError` when it is missing, torn, from an
    unknown version, or was never committed."""
    mpath = os.path.join(path, _METADATA)
    try:
        with open(mpath) as f:
            meta = json.load(f)
    except FileNotFoundError:
        raise CorruptCheckpointError(
            f"{path}: no {_METADATA} — not a committed checkpoint "
            f"(torn write from a crashed save, or wrong directory)")
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CorruptCheckpointError(f"{path}: torn {_METADATA}: {e}")
    if meta.get("version") not in _KNOWN_VERSIONS:
        raise CorruptCheckpointError(
            f"{path}: unknown checkpoint version {meta.get('version')}")
    if meta.get("version", 0) >= 2 and not meta.get("committed"):
        raise CorruptCheckpointError(
            f"{path}: manifest present but not committed")
    return meta


def _hash_file(fpath: str) -> str:
    h = hashlib.sha256()
    with open(fpath, "rb") as f:
        for blk in iter(lambda: f.read(1 << 20), b""):
            h.update(blk)
    return h.hexdigest()


def _check_size(root: str, chunk: Dict[str, Any]) -> str:
    fpath = os.path.join(root, chunk["file"])
    if not os.path.exists(fpath):
        raise CorruptCheckpointError(
            f"{root}: missing chunk file {chunk['file']!r}")
    want_bytes = chunk.get("bytes")
    if want_bytes is not None and os.path.getsize(fpath) != want_bytes:
        raise CorruptCheckpointError(
            f"{root}: chunk {chunk['file']!r} is {os.path.getsize(fpath)} "
            f"bytes, manifest says {want_bytes} (truncated write?)")
    return fpath


def _verify_chunk(root: str, chunk: Dict[str, Any], cache: Set[str]):
    """sha256-verify one chunk file against the manifest (once a load)."""
    rel = chunk["file"]
    if rel in cache:
        return
    fpath = _check_size(root, chunk)
    want = chunk.get("sha256")
    if want is not None and _hash_file(fpath) != want:
        raise CorruptCheckpointError(
            f"{root}: chunk {rel!r} sha256 mismatch (bit-rot or torn "
            f"write)")
    cache.add(rel)


def validate_checkpoint(path: str, deep: bool = True) -> Dict[str, Any]:
    """Integrity-check a checkpoint dir without materializing arrays:
    committed manifest, every chunk file present with the manifest's
    size, and (``deep=True``) matching sha256.  Returns the metadata;
    raises :class:`CorruptCheckpointError` on any failure."""
    meta = get_checkpoint_metadata(path)
    cache: Set[str] = set()
    for entry in meta["arrays"].values():
        for chunk in entry["chunks"]:
            if deep:
                _verify_chunk(path, chunk, cache)
            else:
                _check_size(path, chunk)
    return meta


def _storage_dtype(name: str) -> np.dtype:
    """The numpy dtype a chunk of manifest dtype ``name`` is read as:
    the extension dtypes as integers of their width."""
    if name in _EXTENSION:
        return np.dtype(_EXTENSION[name][1])
    return np.dtype(name)


def _read_box(path: str, entry: Dict[str, Any],
              verify_cache: Optional[Set[str]] = None,
              want_box=None) -> np.ndarray:
    """Assemble ``want_box`` (default: the whole array) of ``entry``'s
    array from the chunk files that cover it, whatever their boxes (a
    checkpoint sharded over several devices loads whole, or onto
    another set of shards).  Chunks are memory-mapped; with a
    ``verify_cache`` each one read is sha256-verified first."""
    shape = tuple(entry["global_shape"])
    dtype = _storage_dtype(entry["dtype"])
    if want_box is None:
        want_box = _whole_box(shape)
    out = np.empty(tuple(b - a for a, b in want_box), dtype=dtype)
    filled = 0
    for chunk in entry["chunks"]:
        cbox = [tuple(b) for b in chunk["box"]]
        inter = [(max(a0, b0), min(a1, b1))
                 for (a0, a1), (b0, b1) in zip(want_box, cbox)]
        if any(a >= b for a, b in inter):
            continue
        if verify_cache is not None:
            _verify_chunk(path, chunk, verify_cache)
        src = np.load(os.path.join(path, chunk["file"]), mmap_mode="r",
                      allow_pickle=False)
        if src.dtype != dtype:
            # extension dtypes are raw void records in the file
            src = src.view(dtype)
        src_sl = tuple(slice(a - c0, b - c0)
                       for (a, b), (c0, _) in zip(inter, cbox))
        dst_sl = tuple(slice(a - w0, b - w0)
                       for (a, b), (w0, _) in zip(inter, want_box))
        out[dst_sl] = src[src_sl]
        filled += int(np.prod([b - a for a, b in inter]))
    enforce(filled == out.size,
            f"checkpoint chunks do not cover {list(want_box)} (covered "
            f"{filled}/{out.size} elements)",
            error_cls=CorruptCheckpointError)
    return out


def _as_tensor(arr: np.ndarray, name: str) -> torch.Tensor:
    t = torch.from_numpy(arr)
    if name in _EXTENSION:
        t = t.view(_EXTENSION[name][0])
    return t


def load_state_dict(state_dict, path: str, process_group=None,
                    coordinator_rank: int = 0, metadata=None,
                    verify: bool = True):
    """Fill ``state_dict`` (a template tree, e.g. a fresh model's and
    optimizer's state) from the checkpoint at ``path``; returns it.
    A ``ShardedArray`` leaf is filled from the checkpoint over its own
    box, whatever boxes the checkpoint was written in.

    Tensor leaves are overwritten in place, in their own dtype and on
    their own device (the template's precision wins over the
    checkpoint's); numpy leaves are replaced by arrays of their dtype;
    any other leaf by the checkpoint's literal or, for an array, a CPU
    tensor.  With ``verify=True`` (default) every chunk is
    sha256-checked first, and any corruption raises
    :class:`CorruptCheckpointError` before the template is changed."""
    t0 = time.monotonic()
    meta = metadata if metadata is not None else get_checkpoint_metadata(path)
    enforce(meta.get("version") in _KNOWN_VERSIONS,
            f"unknown checkpoint version {meta.get('version')}",
            error_cls=CorruptCheckpointError)
    verify_cache: Optional[Set[str]] = set() if verify else None
    flat = _flatten(state_dict)
    new_flat: Dict[str, Any] = {}
    for key, leaf in flat.items():
        if key in meta["literals"]:
            new_flat[key] = meta["literals"][key]
            continue
        entry = meta["arrays"].get(key)
        enforce(entry is not None, f"{key!r} not found in checkpoint {path}")
        name = entry["dtype"]
        if isinstance(leaf, ShardedArray):
            enforce(tuple(leaf.global_shape) == tuple(entry["global_shape"]),
                    f"{key!r}: template global shape {leaf.global_shape} "
                    f"!= checkpoint global shape "
                    f"{tuple(entry['global_shape'])}")
            arr = _read_box(path, entry, verify_cache, leaf.box)
            new_flat[key] = _as_tensor(arr, name).to(leaf.dtype)
            continue
        arr = _read_box(path, entry, verify_cache)
        if isinstance(leaf, torch.Tensor):
            enforce(tuple(leaf.shape) == tuple(arr.shape),
                    f"{key!r}: template shape {tuple(leaf.shape)} != "
                    f"checkpoint global shape {tuple(arr.shape)}")
            new_flat[key] = _as_tensor(arr, name).to(leaf.dtype)
        elif isinstance(leaf, (np.ndarray, np.generic)):
            enforce(name not in _EXTENSION,
                    f"{key!r}: a {name} array loads into a tensor "
                    f"template, not numpy")
            new_flat[key] = np.asarray(arr.astype(leaf.dtype))
        else:
            new_flat[key] = _as_tensor(arr, name)

    for key, val in new_flat.items():
        _set_in(state_dict, key, val)
    _load_metrics().observe(time.monotonic() - t0)
    return state_dict
