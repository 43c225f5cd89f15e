"""paddle.distributed.TCPStore, the rendezvous key-value store
(counterpart of ``paddle_tpu/distributed/store.py``).

One process hosts the server, every rank connects as a client; the
primitives are set / get (blocking until the key exists) / add (an
atomic counter) / wait / check / delete, and ``barrier`` is built on add.
The server and client are the native ones of ``core/csrc/tcp_store.cpp``
(built with ``g++`` on first use); a python server and client speaking
the same wire protocol stand in where there is no compiler, so native
and python ends interoperate.

``C10dStore`` wraps a ``TCPStore`` as a ``torch.distributed.Store``, so
``init_process_group(store=...)`` rendezvouses through it: one store on
``PADDLE_MASTER`` serves Paddle's API and PyTorch's process groups.
"""
from __future__ import annotations

import datetime
import socket
import struct
import threading
import time
from typing import Dict, List, Optional

import torch.distributed as _dist

from ..common.errors import enforce
from ..core import load_native

__all__ = ["TCPStore", "C10dStore"]

_SET, _GET, _ADD, _WAIT, _DEL, _CHECK = range(6)
_TIMEOUT_SENTINEL = (1 << 64) - 1


# ---------------------------------------------------------------------------
# pure-python server (wire-compatible with core/csrc/tcp_store.cpp)
# ---------------------------------------------------------------------------

class _PyServer:
    def __init__(self, host: str, port: int):
        self._kv: Dict[bytes, bytes] = {}
        self._cond = threading.Condition()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host or "0.0.0.0", port))
        self._sock.listen(128)
        self.port = self._sock.getsockname()[1]
        self._stop = False
        self._threads = []
        t = threading.Thread(target=self._accept, daemon=True)
        t.start()
        self._threads.append(t)

    def _accept(self):
        while not self._stop:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    @staticmethod
    def _read_n(conn, n):
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    def _serve(self, conn):
        try:
            while not self._stop:
                hdr = self._read_n(conn, 5)
                if hdr is None:
                    return
                op, klen = struct.unpack("<BI", hdr)
                key = self._read_n(conn, klen) if klen else b""
                arg = struct.unpack("<Q", self._read_n(conn, 8))[0]
                payload = b""
                if op == _SET:
                    val = self._read_n(conn, arg) if arg else b""
                    with self._cond:
                        self._kv[key] = val
                        self._cond.notify_all()
                elif op in (_GET, _WAIT):
                    deadline = None if arg == 0 else \
                        time.monotonic() + arg / 1000.0
                    with self._cond:
                        while key not in self._kv and not self._stop:
                            left = None if deadline is None else \
                                deadline - time.monotonic()
                            if left is not None and left <= 0:
                                break
                            self._cond.wait(timeout=left)
                        if key not in self._kv:
                            conn.sendall(
                                struct.pack("<Q", _TIMEOUT_SENTINEL))
                            continue
                        payload = self._kv[key] if op == _GET else b""
                elif op == _ADD:
                    delta = struct.unpack("<q", struct.pack("<Q", arg))[0]
                    with self._cond:
                        raw = self._kv.get(key, b"\0" * 8)
                        # non-counter value -> start from 0 (native
                        # server semantics; wire compat)
                        if len(raw) != 8:
                            raw = b"\0" * 8
                        cur = struct.unpack("<q", raw)[0]
                        cur += delta
                        self._kv[key] = struct.pack("<q", cur)
                        payload = self._kv[key]
                        self._cond.notify_all()
                elif op == _DEL:
                    with self._cond:
                        self._kv.pop(key, None)
                elif op == _CHECK:
                    with self._cond:
                        payload = b"1" if key in self._kv else b"0"
                conn.sendall(struct.pack("<Q", len(payload)) + payload)
        except OSError:
            pass
        finally:
            conn.close()

    def stop(self):
        self._stop = True
        with self._cond:
            self._cond.notify_all()
        try:
            self._sock.close()
        except OSError:
            pass


class _PyClient:
    def __init__(self, host, port, timeout_s):
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                self._sock = socket.create_connection((host, port),
                                                      timeout=timeout_s)
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.05)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock.settimeout(None)
        self._lock = threading.Lock()

    def _req(self, op, key: bytes, arg: int, val: bytes = b"") -> bytes:
        with self._lock:
            msg = struct.pack("<BI", op, len(key)) + key + \
                struct.pack("<Q", arg & ((1 << 64) - 1)) + \
                (val if op == _SET else b"")
            self._sock.sendall(msg)
            raw = _PyServer._read_n(self._sock, 8)
            enforce(raw is not None, "TCPStore connection lost")
            (length,) = struct.unpack("<Q", raw)
            if length == _TIMEOUT_SENTINEL:
                raise TimeoutError(f"TCPStore wait timed out on {key!r}")
            return _PyServer._read_n(self._sock, length) if length else b""

    def close(self):
        self._sock.close()


class _NativeClient:
    def __init__(self, lib, host, port, timeout_s):
        self._lib = lib
        self._fd = lib.tcp_store_connect(host.encode(), port,
                                         int(timeout_s * 1000))
        enforce(self._fd >= 0, f"TCPStore connect to {host}:{port} failed")
        self._lock = threading.Lock()

    def _req(self, op, key: bytes, arg: int, val: bytes = b"") -> bytes:
        import ctypes
        lib = self._lib
        with self._lock:
            if op == _SET:
                rc = lib.tcp_store_set(self._fd, key, len(key), val,
                                       len(val))
                enforce(rc == 0, "TCPStore set failed")
                return b""
            if op == _GET:
                out = ctypes.POINTER(ctypes.c_char)()
                olen = ctypes.c_uint64()
                rc = lib.tcp_store_get(self._fd, key, len(key), arg,
                                       ctypes.byref(out),
                                       ctypes.byref(olen))
                if rc == -2:
                    raise TimeoutError(f"TCPStore get timeout {key!r}")
                enforce(rc == 0, "TCPStore get failed")
                data = ctypes.string_at(out, olen.value) \
                    if olen.value else b""
                if olen.value:
                    lib.tcp_store_free(out)
                return data
            if op == _ADD:
                res = ctypes.c_int64()
                rc = lib.tcp_store_add(self._fd, key, len(key), arg,
                                       ctypes.byref(res))
                enforce(rc == 0, "TCPStore add failed")
                return struct.pack("<q", res.value)
            if op == _WAIT:
                rc = lib.tcp_store_wait(self._fd, key, len(key), arg)
                if rc == -2:
                    raise TimeoutError(f"TCPStore wait timeout {key!r}")
                enforce(rc == 0, "TCPStore wait failed")
                return b""
            if op == _DEL:
                lib.tcp_store_delete(self._fd, key, len(key))
                return b""
            if op == _CHECK:
                ex = ctypes.c_int()
                rc = lib.tcp_store_check(self._fd, key, len(key),
                                         ctypes.byref(ex))
                enforce(rc == 0, "TCPStore check failed")
                return b"1" if ex.value else b"0"
        raise ValueError(op)

    def close(self):
        self._lib.tcp_store_close(self._fd)


class TCPStore:
    """paddle.distributed.TCPStore(host, port, world_size, is_master,
    timeout).  ``is_master`` hosts the server (``port`` 0 binds a free
    port; ``self.port`` is the one bound) and connects to it; every
    other instance is a client of ``host:port``."""

    def __init__(self, host: str, port: int, world_size: int = 1,
                 is_master: bool = False, timeout: float = 300.0):
        self.host, self.world_size, self.timeout = host, world_size, timeout
        self._server = None
        self._native_server = None
        lib = load_native()
        if is_master:
            if lib is not None:
                import ctypes
                out_port = ctypes.c_int()
                h = lib.tcp_store_server_start(host.encode(), port,
                                               ctypes.byref(out_port))
                enforce(h, f"TCPStore bind {host}:{port} failed")
                self._native_server = h
                port = out_port.value
            else:
                self._server = _PyServer(host, port)
                port = self._server.port
        self.port = port
        if lib is not None:
            self._client = _NativeClient(lib, host, port, timeout)
        else:
            self._client = _PyClient(host, port, timeout)

    @property
    def is_native(self) -> bool:
        return isinstance(self._client, _NativeClient)

    # -- API ------------------------------------------------------------------
    def set(self, key: str, value) -> None:
        if isinstance(value, str):
            value = value.encode()
        self._client._req(_SET, key.encode(), len(value), bytes(value))

    def get(self, key: str, timeout_ms: int = 0) -> bytes:
        return self._client._req(_GET, key.encode(), timeout_ms)

    def add(self, key: str, delta: int) -> int:
        out = self._client._req(_ADD, key.encode(), int(delta))
        return struct.unpack("<q", out)[0]

    def wait(self, keys, timeout_ms: int = 0) -> None:
        if isinstance(keys, str):
            keys = [keys]
        for k in keys:
            self._client._req(_WAIT, k.encode(), timeout_ms)

    def delete_key(self, key: str) -> None:
        self._client._req(_DEL, key.encode(), 0)

    def check(self, key: str) -> bool:
        return self._client._req(_CHECK, key.encode(), 0) == b"1"

    def barrier(self, name: str = "_barrier", timeout_ms: int = 60000):
        """All world_size ranks arrive, then proceed.  Reusable: each
        world_size-full round of arrivals forms an epoch with its own
        release key (a single '/go' key would make every later barrier
        a no-op)."""
        n = self.add(f"{name}/count", 1)
        epoch = (n - 1) // self.world_size
        if n % self.world_size == 0:
            self.set(f"{name}/go{epoch}", b"1")
        self.wait(f"{name}/go{epoch}", timeout_ms)

    def client(self) -> "TCPStore":
        """A new client connection to the same server (for a thread
        that must not queue behind this connection's blocking waits)."""
        return TCPStore(self.host, self.port, self.world_size,
                        timeout=self.timeout)

    def close(self) -> None:
        """Close the connection and stop the server this instance
        hosts (idempotent)."""
        client, self._client = getattr(self, "_client", None), None
        if client is not None:
            client.close()
        if self._server is not None:
            self._server.stop()
            self._server = None
        if self._native_server is not None:
            load_native().tcp_store_server_stop(self._native_server)
            self._native_server = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _ms(timeout) -> int:
    if isinstance(timeout, datetime.timedelta):
        timeout = timeout.total_seconds()
    return max(1, int(timeout * 1000))


class C10dStore(_dist.Store):
    """A ``TCPStore`` as a ``torch.distributed.Store``: what
    ``init_process_group(store=...)`` and ``new_group`` rendezvous
    through.  Blocking reads wait at most the store's timeout (c10d's
    ``set_timeout``; the TCPStore's own to begin with).  Counters keep
    the wire protocol's 8-byte encoding; ``compare_set``, ``num_keys``
    and the queue calls, which the protocol lacks, raise."""

    def __init__(self, store: TCPStore):
        super().__init__()
        self.store = store
        self._timeout_ms = _ms(store.timeout)
        self._clones: List["C10dStore"] = []

    def set_timeout(self, timeout):
        self._timeout_ms = _ms(timeout)

    def set(self, key, value):
        self.store.set(key, value)

    def get(self, key):
        return self.store.get(key, timeout_ms=self._timeout_ms)

    def add(self, key, value):
        return self.store.add(key, value)

    def wait(self, keys, timeout=None):
        self.store.wait(list(keys), timeout_ms=self._timeout_ms
                        if timeout is None else _ms(timeout))

    def check(self, keys):
        return all(self.store.check(k) for k in keys)

    def delete_key(self, key):
        existed = self.store.check(key)
        self.store.delete_key(key)
        return existed

    def multi_get(self, keys):
        return [self.get(k) for k in keys]

    def multi_set(self, keys, values):
        for k, v in zip(keys, values):
            self.set(k, v)

    def append(self, key, value):
        if isinstance(value, str):
            value = value.encode()
        old = self.store.get(key, timeout_ms=1) \
            if self.store.check(key) else b""
        self.store.set(key, old + bytes(value))

    def clone(self):
        # c10d keeps only its C++ handle on the clone: this reference
        # keeps the python object (and its methods) alive with it
        c = C10dStore(self.store.client())
        self._clones.append(c)
        return c

    def compare_set(self, key, expected, desired):
        raise NotImplementedError("TCPStore has no compare_set")

    def num_keys(self):
        raise NotImplementedError("TCPStore has no num_keys")
