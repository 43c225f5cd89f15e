"""The port's RNG stream (counterpart of ``paddle_tpu/ops/random.py``:
``seed``, ``rng_guard``, ``split_key``, ``rand``, ``randn``,
``randint``).

The reference threads a splittable ``jax.random`` key: a global one, or
inside ``rng_guard(key)`` the trainer's per-step key, split once for
every random op.  Here the stream is a ``torch.Generator`` on the
model's device:

- ``rng_guard(generator)`` routes every draw inside the context to
  ``generator`` (``CompiledTrainStep`` owns one, seeded from its
  ``seed``, and runs each forward under it);
- outside any guard a draw takes the device's default generator, seeded
  with 0 (the reference's global key before any ``paddle.seed``);
- ``generator_for(device)`` is the generator a draw on ``device`` uses
  (plain dropout draws its keep mask from it, ``ops/_nn.py``);
- ``next_seed(device)`` draws one per-call seed for an in-kernel
  dropout mask as an int64 scalar **on the device**: the draw advances
  the generator's own counter, and no value crosses to the host, so a
  training step never waits for it;
- ``rand``, ``randn`` and ``randint`` draw uniform, normal and integer
  tensors on ``device`` from the same generator (the diffusion model's
  timesteps, noise and label drop, ``models/dit.py``), so under the
  trainer's guard they follow its seed too.

``jax.random`` and ``torch.Generator`` give other numbers from one seed:
no draw here equals the reference's bit for bit (the tests hand both
frameworks numpy noise where they compare).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict

import torch

__all__ = ["rng_guard", "generator_for", "next_seed", "rand", "randn",
           "randint"]

_SEED_HIGH = 2 ** 31 - 1      # the reference draws int32 seeds in [0, 2^31 - 1)

_state = threading.local()
_defaults: Dict[torch.device, torch.Generator] = {}
_lock = threading.Lock()


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@contextlib.contextmanager
def rng_guard(generator: torch.Generator):
    """Route every draw inside the context to ``generator``."""
    prev = getattr(_state, "gen", None)
    _state.gen = generator
    try:
        yield generator
    finally:
        _state.gen = prev


def generator_for(device) -> torch.Generator:
    """The generator a draw on ``device`` takes: the guarded one, else
    the device's default.  A guarded generator on another device than
    the draw raises."""
    dev = _device(device)
    gen = getattr(_state, "gen", None)
    if gen is not None:
        if _device(gen.device) != dev:
            raise ValueError(f"the guarded generator lives on {gen.device}, "
                             f"the draw on {dev}")
        return gen
    with _lock:
        gen = _defaults.get(dev)
        if gen is None:
            gen = torch.Generator(device=dev).manual_seed(0)
            _defaults[dev] = gen
    return gen


def next_seed(device) -> torch.Tensor:
    """A fresh per-call seed: an int64 scalar tensor on ``device``,
    drawn from ``generator_for(device)`` without a host sync."""
    dev = _device(device)
    return torch.randint(0, _SEED_HIGH, (), generator=generator_for(dev),
                         device=dev, dtype=torch.int64)


def _shape(shape):
    return [int(s) for s in shape]


def rand(shape, *, device) -> torch.Tensor:
    """Uniform [0, 1) f32 of ``shape`` on ``device``."""
    dev = _device(device)
    return torch.rand(_shape(shape), generator=generator_for(dev),
                      device=dev, dtype=torch.float32)


def randn(shape, dtype=torch.float32, *, device) -> torch.Tensor:
    """Standard normal of ``shape`` on ``device``, drawn in f32 and cast
    to ``dtype``."""
    dev = _device(device)
    out = torch.randn(_shape(shape), generator=generator_for(dev),
                      device=dev, dtype=torch.float32)
    return out.to(dtype)


def randint(low=0, high=None, shape=(1,), *, device) -> torch.Tensor:
    """Integers in [low, high) (``[0, low)`` when ``high`` is None) of
    ``shape`` on ``device``, int32 as the reference's."""
    if high is None:
        low, high = 0, low
    dev = _device(device)
    return torch.randint(int(low), int(high), _shape(shape),
                         generator=generator_for(dev), device=dev,
                         dtype=torch.int32)
