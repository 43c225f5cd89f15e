"""Threefry-2x32 random streams, bit for bit those of ``jax.random``.

The reference samples with ``jax.random`` under its default threefry2x32
implementation with ``jax_threefry_partitionable`` on.  That generator is
32-bit integer arithmetic only, so this module replays it exactly: the
same key words from the same seed, the same ``split`` / ``fold_in``
children, the same raw bits, the same uniforms and, through the same
Gumbel-max, the same ``categorical`` draws (up to the last bit of
``log``, which the two libraries round on their own).

Words are carried in ``int64`` values masked to 32 bits (Python ints,
numpy arrays or tensors: one hash serves all three), so one code path
runs on the CPU and on CUDA (PyTorch's ``uint32`` lacks shifts on CUDA).
A key is a CPU ``int64`` tensor of its two words: the engine derives
keys on the host, as the reference does.  The bits of a whole-vocabulary
draw are made on the device of the logits they perturb; the few entries
that a top-k / top-p filter leaves, and the per-row keys, are hashed on
the host in numpy (a few hundred elements: the hash's 170 elementwise
steps cost microseconds there and a kernel launch each on the card).

Counter layouts (``jax/_src/prng.py``):

- ``split(key)[i]`` and ``fold_in(key, i)`` are both
  ``threefry2x32(key, (0, i))``;
- ``random_bits(key, shape)`` hashes the row-major flat index ``n`` of
  every element as ``(n >> 32, n & 0xffffffff)`` and XORs the two output
  words;
- a dense draw over ``[B, V]`` with one key therefore counts ``b * V +
  v``; a per-row draw (``fold_in(key, row)``, then ``[V]``) counts ``v``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

__all__ = ["prng_key", "as_key", "threefry2x32", "split", "fold_in",
           "fold_in_rows", "random_bits", "uniform", "gumbel",
           "categorical"]

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# float32: the smallest normal number, and the bits of 1.0
_F32_TINY = float(np.finfo(np.float32).tiny)
_ONE_BITS = 0x3F800000

KeyLike = Union[torch.Tensor, np.ndarray, Sequence[int]]


def prng_key(seed: int) -> torch.Tensor:
    """The words of ``jax.random.PRNGKey(seed)`` (32-bit seeds: the
    seed is truncated to its low 32 bits, the high word is 0)."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64)


def as_key(key: KeyLike) -> torch.Tensor:
    """A key's two words as a CPU ``int64`` tensor (from a tensor, a
    numpy array or a list of ints, such as ``key_fingerprint``'s)."""
    if isinstance(key, torch.Tensor):
        words = key.detach().to("cpu", torch.int64).reshape(-1)
    else:
        words = torch.tensor(np.asarray(key, dtype=np.int64).reshape(-1),
                             dtype=torch.int64)
    if words.numel() != 2:
        raise ValueError(f"a threefry key has 2 words, got {words.numel()}")
    return words & MASK


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counter words ``(x1, x2)``
    under key words ``(k1, k2)``: Python ints or ``int64`` tensors
    holding 32-bit values, broadcast together.  Returns the two output
    words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def _words(key: KeyLike):
    k = as_key(key)
    return int(k[0]), int(k[1])


def split(key: KeyLike, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``[num, 2]`` child keys (hashed
    on the host, as Python ints)."""
    k1, k2 = _words(key)
    return torch.tensor([threefry2x32(k1, k2, i >> 32, i & MASK)
                         for i in range(num)], dtype=torch.int64)


def fold_in(key: KeyLike, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` (data taken as uint32)."""
    k1, k2 = _words(key)
    return torch.tensor(threefry2x32(k1, k2, 0, int(data) & MASK),
                        dtype=torch.int64)


def fold_in_rows(key: KeyLike, rows) -> torch.Tensor:
    """``fold_in(key, r)`` for every ``r`` of ``rows`` at once (hashed
    on the host): ``[R, 2]`` CPU keys."""
    k1, k2 = _words(key)
    rows = np.asarray(rows, np.int64) & MASK
    w1, w2 = threefry2x32(k1, k2, np.zeros_like(rows), rows)
    return torch.from_numpy(np.stack([w1, w2], axis=-1))


def _bits_at(k1, k2, counter):
    """32-bit random words of the flat element indices ``counter``
    (``int64``, tensor or numpy) under key words (k1, k2) (broadcast)."""
    b1, b2 = threefry2x32(k1, k2, counter >> 32, counter & MASK)
    return b1 ^ b2


def random_bits(key: KeyLike, shape, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as ``int64`` words, made
    on ``device`` (the CPU by default, there in numpy)."""
    k1, k2 = _words(key)
    n = int(np.prod(shape, dtype=np.int64))
    device = torch.device(device or "cpu")
    if device.type == "cpu":
        bits = torch.from_numpy(_bits_at(k1, k2, np.arange(n, dtype=np.int64)))
    else:
        bits = _bits_at(k1, k2, torch.arange(n, dtype=torch.int64,
                                             device=device))
    return bits.reshape(tuple(shape))


def _unit_float(bits):
    """f32 in [0, 1) from 32-bit words: the top 23 bits as the mantissa
    of a number in [1, 2), less 1 (``jax.random._uniform``)."""
    f = ((bits >> 9) | _ONE_BITS).to(torch.int32).view(torch.float32)
    return f - 1.0


def _uniform_from_bits(bits, minval: float, maxval: float):
    # the bounds and their difference as f32 values (exact in Python
    # floats), so the product and sum round as the reference's f32 ones
    lo = float(np.float32(minval))
    scale = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp_min(_unit_float(bits) * scale + lo, lo)


def uniform(key: KeyLike, shape=(), minval: float = 0.0,
            maxval: float = 1.0, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    return _uniform_from_bits(random_bits(key, shape, device), minval,
                              maxval)


def _gumbel_from_bits(bits):
    """``jax.random.gumbel`` in mode "low": ``-log(-log(u))`` with u
    uniform in [tiny, 1)."""
    return -torch.log(-torch.log(_uniform_from_bits(bits, _F32_TINY, 1.0)))


def gumbel(key: KeyLike, shape=(), device=None) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` (mode "low")."""
    return _gumbel_from_bits(random_bits(key, shape, device))


def categorical(key: KeyLike, logits: torch.Tensor,
                row_keys: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` over f32 logits
    ``[B, V]``: the arg max of logits plus Gumbel noise, the first index
    on ties.  Returns ``[B]`` int64.

    Without ``row_keys`` one key perturbs the whole ``[B, V]`` block
    (counters ``b * V + v``), the reference's dense draw; with
    ``row_keys`` ``[B, 2]`` row b draws on its own key over ``[V]``
    (counters ``v``), the reference's ``vmap`` of per-row draws.

    Only entries that can win need their noise: where at most a quarter
    of a row's logits are finite (top-k / top-p filtering leaves the rest
    at -inf), the noise is made for the finite ones alone, at their own
    counters and on the host, which gives the same arg max as the whole
    draw; else the whole block's noise is made on the logits' device."""
    b, v = logits.shape
    dev = logits.device
    if row_keys is None:
        k1, k2 = _words(key)
        base = np.arange(b, dtype=np.int64)[:, None] * v
    else:
        rk = row_keys.cpu().numpy()
        k1, k2 = rk[:, 0:1], rk[:, 1:2]
        base = np.zeros((b, 1), np.int64)
    m = int((logits > float("-inf")).sum(dim=-1).max())
    if 0 < m <= v // 4:
        # the m largest logits hold every finite entry of each row; in
        # column order, so the arg max breaks ties at the first index
        idx = torch.topk(logits, m, dim=-1).indices.sort(dim=-1).values
        vals = logits.gather(-1, idx).cpu()
        idx = idx.cpu()
        noise = _gumbel_from_bits(torch.from_numpy(
            _bits_at(k1, k2, base + idx.numpy())))
        pick = torch.argmax(vals + noise, dim=-1, keepdim=True)
        return idx.gather(-1, pick)[:, 0].to(dev)
    t = lambda a: torch.as_tensor(a, device=dev)   # noqa: E731
    cols = torch.arange(v, dtype=torch.int64, device=dev)[None, :]
    noise = _gumbel_from_bits(_bits_at(t(k1), t(k2), t(base) + cols))
    return torch.argmax(logits + noise, dim=-1)
