"""The serving engine's sampling-key contract (counterpart of
``paddle_tpu/inference/sampling.py``).

The engine key forks one subkey per window (``split``); inside a window
every step splits the window key once (``split_step``) and samples with
the subkey.  A row draws on ``fold_row(step_subkey, row)``, so a
request's tokens depend on the key chain and its draw id, never on which
other requests share the batch.  Speculative windows derive their draft,
acceptance and resample roots from the window key by ``fold_in`` tags
(``spec_window_keys``), and per-(step, row) draws by ``spec_draw_key``.

Keys are the two words of a threefry key (``common/prng.py``), the
reference's ``jax.random`` keys word for word, so ``key_fingerprint`` and
``key_from_fingerprint`` mean the same in both packages.
"""
from __future__ import annotations

from ..common import prng
from ..nn.generation import sample_logits

__all__ = ["split_step", "window_keys", "key_fingerprint",
           "key_from_fingerprint", "sample_logits", "fold_row",
           "spec_window_keys", "spec_draw_key"]

# fold_in tags of a speculative window's three roots
_SPEC_DRAFT_TAG = 0x5bec0d01     # draft propose chain root
_SPEC_ACCEPT_TAG = 0x5bec0d02    # acceptance-uniform root
_SPEC_RESAMPLE_TAG = 0x5bec0d03  # rejection-resample / bonus root


def spec_window_keys(key):
    """One speculative window's (draft, accept, resample) roots from its
    window key."""
    return (prng.fold_in(key, _SPEC_DRAFT_TAG),
            prng.fold_in(key, _SPEC_ACCEPT_TAG),
            prng.fold_in(key, _SPEC_RESAMPLE_TAG))


def spec_draw_key(root, step: int, row: int):
    """The acceptance / resample key of (step, row): the step folds
    first, then the row (``fold_row``)."""
    return fold_row(prng.fold_in(root, int(step)), int(row))


def fold_row(key, row: int):
    """A row's sample key: ``fold_in(step_subkey, row)``."""
    return prng.fold_in(key, int(row))


def split_step(key):
    """One decode step's keys: ``(next_key, step_subkey)``."""
    next_key, sub = prng.split(key)
    return next_key, sub


def key_fingerprint(key):
    """A key's two words as a list of ints (JSON-able)."""
    return [int(w) for w in prng.as_key(key).tolist()]


def key_from_fingerprint(words):
    """The key of ``key_fingerprint``'s words."""
    return prng.as_key(list(words))


def window_keys(key, n_steps: int):
    """An ``n_steps`` window's step subkeys and final key:
    ``([sub_0, ..., sub_{n-1}], final_key)``."""
    subs = []
    for _ in range(int(n_steps)):
        key, sub = split_step(key)
        subs.append(sub)
    return subs, key
