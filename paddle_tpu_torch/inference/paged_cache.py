"""Paged KV cache manager for the serving path.

Counterpart of ``paddle_tpu/inference/paged_cache.py``.  Host-side page
accounting (free list, per-sequence page lists, reference counts, the
prefix index) stays in Python and is the reference's line for line; the
page pools are device tensors ``[L, KVH, n_pages, P, D]`` that the
ragged kernel (``ops/paged_attention.py``) updates in place.

One object manages all decoder layers: a token occupies the same
(page, slot) in every layer.  Page 0 is the reserved pad page and is
never handed out.

Automatic prefix caching: pages are reference-counted, and full,
immutable prefill pages can be registered in an index keyed by the
chain of token-block hashes — block k's key digests block k-1's key, so
a key names the whole prefix.  ``lookup_prefix`` walks the chain,
``allocate(shared_pages=...)`` maps the hits into a new slot's table,
and ``release`` parks unreferenced registered pages in an LRU pool that
``allocate``/``extend`` evict from only when the free list is dry.  A
write into a shared page copies it first (``_make_private``), so shared
content never changes.

Not ported yet: int8 pools, swap (preemption), export/import
(migration) and rollback (speculative decoding) — ROADMAP 'Port slice
2' and 'Port: remaining modules'.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..common.errors import enforce
from ..runtime.device import resolve_device

__all__ = ["PagedKVCache"]


def _chain_hash(prev: bytes, tokens) -> bytes:
    """Key for one full token block given the previous block's key."""
    h = hashlib.blake2b(prev, digest_size=16)
    h.update(np.asarray(tokens, np.int64).tobytes())
    return h.digest()


class PagedKVCache:
    def __init__(self, n_pages: int, page_size: int, n_kv_heads: int,
                 head_dim: int, max_seqs: int, max_len: int,
                 dtype: torch.dtype = torch.float32, num_layers: int = 1,
                 device=None):
        self.device = resolve_device(device)
        self.n_pages = n_pages
        self.page_size = page_size
        self.num_layers = num_layers
        self.max_pages_per_seq = (max_len + page_size - 1) // page_size
        # [L, KVH, n_pages, P, D]
        self.k_pages = torch.zeros((num_layers, n_kv_heads, n_pages,
                                    page_size, head_dim), dtype=dtype,
                                   device=self.device)
        self.v_pages = torch.zeros_like(self.k_pages)
        self._free = list(range(n_pages - 1, 0, -1))   # page 0 = pad
        self._pages: Dict[int, List[int]] = {}
        self._lens = np.zeros(max_seqs, np.int32)
        self._table = np.zeros((max_seqs, self.max_pages_per_seq),
                               np.int32)
        self._used = [False] * max_seqs
        # prefix caching: per-page reference counts, the chain-hash
        # index over registered full prefill pages, and the LRU pool of
        # registered pages nobody references
        self._ref = np.zeros(n_pages, np.int64)
        self._index: Dict[bytes, int] = {}       # chain key -> page
        self._page_key: Dict[int, bytes] = {}    # page -> chain key
        self._lru: "OrderedDict[int, None]" = OrderedDict()

    # -- prefix-caching internals ----------------------------------------------
    def _unregister(self, pg: int):
        key = self._page_key.pop(pg)
        del self._index[key]

    def _grab_page(self, what: str) -> int:
        """One page off the free list, evicting the LRU-oldest cached
        prefix page when the list is dry."""
        if self._free:
            pg = self._free.pop()
        elif self._lru:
            pg, _ = self._lru.popitem(last=False)      # oldest first
            self._unregister(pg)
        else:
            enforce(False, f"paged cache OOM on {what}: no free or "
                           f"evictable pages")
        self._ref[pg] = 1
        return pg

    def _unref(self, pg: int) -> bool:
        """Drop one reference; True if the page went back to the free
        list (registered pages park in the LRU pool instead)."""
        self._ref[pg] -= 1
        if self._ref[pg] > 0:
            return False
        if pg in self._page_key:
            self._lru[pg] = None                       # newest at end
            return False
        self._free.append(pg)
        return True

    def _copy_page(self, src: int, dst: int):
        """Copy one physical page in every layer, K and V."""
        self.k_pages[:, :, dst] = self.k_pages[:, :, src]
        self.v_pages[:, :, dst] = self.v_pages[:, :, src]

    def _make_private(self, slot: int, idx: int):
        """Copy-on-write guard before writing into the slot's idx-th
        page: a shared page (ref > 1) is copied to a fresh page first;
        a solely-owned but registered page just unregisters (its content
        is about to diverge from the indexed prefix)."""
        pg = self._pages[slot][idx]
        if self._ref[pg] > 1:
            npg = self._grab_page("copy-on-write")
            self._copy_page(pg, npg)
            self._unref(pg)
            self._pages[slot][idx] = npg
            self._table[slot, idx] = npg
        elif pg in self._page_key:
            self._unregister(pg)

    # -- host-side accounting --------------------------------------------------
    def allocate(self, n_tokens: int, shared_pages=()) -> int:
        """Reserve a sequence slot with capacity for n_tokens; returns
        the slot id.  ``shared_pages`` (from ``lookup_prefix``) map
        read-shared into the front of the slot's page table; only the
        remainder comes off the free list."""
        free_slots = [i for i, u in enumerate(self._used) if not u]
        enforce(free_slots, "paged cache: all sequence slots in use")
        slot = free_slots[0]
        need = (n_tokens + self.page_size - 1) // self.page_size
        shared = list(shared_pages)
        enforce(len(shared) <= need,
                f"paged cache: {len(shared)} shared pages exceed the "
                f"{need}-page capacity request")
        # pin the shared pages first so grabbing the remainder can never
        # evict them out from under this allocation
        for pg in shared:
            self._ref[pg] += 1
            if pg in self._lru:
                del self._lru[pg]
        avail = len(self._free) + len(self._lru)
        if avail < need - len(shared):
            for pg in reversed(shared):
                self._unref(pg)
            enforce(False,
                    f"paged cache OOM: need {need - len(shared)} "
                    f"pages, {avail} free/evictable")
        pages = shared + [self._grab_page("allocate")
                          for _ in range(need - len(shared))]
        self._used[slot] = True
        self._pages[slot] = pages
        self._lens[slot] = 0
        self._table[slot, :] = 0
        self._table[slot, :need] = pages
        return slot

    def extend(self, slot: int, n_tokens: int = 1):
        """Ensure capacity for n_tokens more; grabs pages as needed.
        Attached pages the new tokens land in are made private first
        (copy-on-write)."""
        pages = self._pages[slot]
        cur = int(self._lens[slot])
        need_total = cur + n_tokens
        if n_tokens > 0 and pages:
            first = cur // self.page_size
            last = (need_total - 1) // self.page_size
            for idx in range(first, min(last, len(pages) - 1) + 1):
                self._make_private(slot, idx)
        have = len(pages) * self.page_size
        while have < need_total:
            pg = self._grab_page("extend")
            idx = len(pages)
            pages.append(pg)
            self._table[slot, idx] = pg
            have += self.page_size

    def release(self, slot: int):
        """Drop the slot's page references.  Unregistered pages return
        to the free list; registered ones park in the LRU pool."""
        pages = self._pages.pop(slot)
        for pg in reversed(pages):
            self._unref(pg)
        self._used[slot] = False
        self._lens[slot] = 0
        self._table[slot, :] = 0

    # -- prefix index ----------------------------------------------------------
    def lookup_prefix(self, token_ids) -> Tuple[int, List[int]]:
        """Longest page-aligned cached prefix of ``token_ids``:
        (n_cached_tokens, pages).  Pure host work."""
        token_ids = list(token_ids)
        P = self.page_size
        key = b""
        pages: List[int] = []
        for i in range(len(token_ids) // P):
            key = _chain_hash(key, token_ids[i * P:(i + 1) * P])
            pg = self._index.get(key)
            if pg is None:
                break
            pages.append(pg)
        return len(pages) * P, pages

    def register_prefix(self, slot: int, token_ids,
                        upto: Optional[int] = None) -> int:
        """Publish the slot's full, written prefill pages into the index
        (first ``upto`` tokens, rounded down to whole pages and clamped
        to the written length).  First writer wins.  Returns the number
        of pages newly registered."""
        P = self.page_size
        n = len(token_ids) if upto is None else min(upto, len(token_ids))
        n = min(n, int(self._lens[slot]))
        key = b""
        added = 0
        for i in range(n // P):
            key = _chain_hash(key, token_ids[i * P:(i + 1) * P])
            pg = self._pages[slot][i]
            if key not in self._index and pg not in self._page_key:
                self._index[key] = pg
                self._page_key[pg] = key
                added += 1
        return added

    def cached_page_count(self) -> int:
        """Registered prefix pages currently unreferenced (evictable)."""
        return len(self._lru)

    def shared_page_count(self) -> int:
        """Physical pages mapped by more than one slot right now."""
        return int((self._ref > 1).sum())

    def page_ref_count(self, page: int) -> int:
        return int(self._ref[page])

    # -- lengths ---------------------------------------------------------------
    def set_len(self, slot: int, n: int):
        """Host-side length after a prefill wrote the pages directly."""
        self._lens[slot] = n

    def advance(self, slots, n: int = 1):
        for s in np.atleast_1d(slots):
            self._lens[s] += n

    @property
    def seq_lens(self) -> np.ndarray:
        return self._lens

    @property
    def page_table(self) -> np.ndarray:
        return self._table

    def free_pages(self) -> int:
        """Pages an ``allocate`` can obtain right now: the free list plus
        the evictable prefix-cached LRU pool."""
        return len(self._free) + len(self._lru)

    def free_slot_count(self) -> int:
        """Sequence slots not currently bound to a live request."""
        return sum(1 for u in self._used if not u)
