"""Pretraining token-file reader over the native dataio core
(counterpart of ``paddle_tpu/io/token_dataset.py``).

The native path (``core/csrc/dataio.cpp``) mmaps the shard and assembles
``[batch, seq_len]`` blocks on background C++ threads into a prefetch
ring; the python path is a plain ``np.memmap`` slice.  Both give numpy
blocks on the host; the trainer copies them to the card.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from ..common.errors import enforce
from ..core import load_native
from .dataloader import Dataset

__all__ = ["TokenFileDataset", "TokenFileLoader"]


class TokenFileDataset(Dataset):
    """Map-style view: item i = tokens [i*seq_len, (i+1)*seq_len)."""

    def __init__(self, path: str, seq_len: int, dtype=np.int32):
        self.path = path
        self.seq_len = seq_len
        self.dtype = np.dtype(dtype)
        self._mm = np.memmap(path, dtype=self.dtype, mode="r")
        self._n = len(self._mm) // seq_len

    def __getitem__(self, i):
        s = i * self.seq_len
        return np.asarray(self._mm[s:s + self.seq_len])

    def __len__(self):
        return self._n


class TokenFileLoader:
    """High-throughput [batch, seq_len] iterator (the trainer hot path).

    Native: C++ mmap + worker threads + prefetch ring.  Python path:
    memmap slicing (same batches; the same shuffle order is NOT
    guaranteed between the two: seed the native path explicitly when
    bit-stable epochs matter)."""

    def __init__(self, path: str, seq_len: int, batch_size: int,
                 dtype=np.int32, num_threads: int = 2,
                 shuffle_seed: Optional[int] = None):
        enforce(os.path.exists(path), f"no token file at {path}")
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.dtype = np.dtype(dtype)
        self._lib = load_native()
        self._h = None
        if self._lib is not None:
            self._h = self._lib.dataio_open(
                path.encode(), self.dtype.itemsize, seq_len, batch_size,
                num_threads,
                -1 if shuffle_seed is None else shuffle_seed)
        if self._h:
            self._n = int(self._lib.dataio_num_batches(self._h))
        else:                      # python path
            self._mm = np.memmap(path, dtype=self.dtype, mode="r")
            n_seqs = len(self._mm) // seq_len
            self._n = n_seqs // batch_size
            enforce(self._n > 0, "token file smaller than one batch")
            self._order = np.arange(n_seqs)
            if shuffle_seed is not None:
                np.random.default_rng(shuffle_seed).shuffle(self._order)
            self._i = 0

    @property
    def is_native(self) -> bool:
        return self._h is not None

    def __len__(self):
        return self._n

    def next(self) -> np.ndarray:
        """Next [batch, seq_len] block (wraps around epochs forever)."""
        out = np.empty((self.batch_size, self.seq_len), self.dtype)
        if self._h:
            rc = self._lib.dataio_next(
                self._h, out.ctypes.data_as(ctypes.c_void_p))
            enforce(rc >= 0, "dataio reader shut down")
            return out
        b = self._i % self._n
        self._i += 1
        idx = self._order[b * self.batch_size:(b + 1) * self.batch_size]
        for r, s in enumerate(idx):
            out[r] = self._mm[s * self.seq_len:(s + 1) * self.seq_len]
        return out

    def __iter__(self):
        for _ in range(self._n):
            yield self.next()

    def close(self):
        if self._h:
            self._lib.dataio_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
