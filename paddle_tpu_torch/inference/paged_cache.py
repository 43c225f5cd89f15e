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

``kv_dtype="int8"`` stores the pools as int8 codes with one f32 absmax
scale per token row in the scale pools ``k_scales``/``v_scales`` [L,
KVH, n_pages, P]; the kernels quantize rows on the way in and
dequantize pages as they read them, and a copied page carries its scale
rows.  ``append``/``attend`` are the cache's own decode-step entry
points (the engine's forwards call the kernels directly).

Float pools may hold another float dtype than the model (``dtype``):
the kernels cast each appended row to the pool dtype.

KV swap (preemption): ``swap_out(slot)`` copies the slot's private
written pages (and int8 scale rows) into a bounded host swap pool of
``swap_pool_pages`` pages and releases every device page; shared prefix
pages are not copied, only unpinned, and recorded by their chain key so
``swap_in`` can re-pin them.  ``swap_in(handle, n_tokens)`` restores the
sequence into a fresh slot with its full page budget.  A full or
disabled pool makes ``swap_out`` release-only (``None``), and an
evicted shared page or too few free pages make ``swap_in`` return
``None``: the caller then recomputes the KV from the token history.
Host copies go through pinned CPU tensors (on a CUDA cache) and finish
before the pages return to the free list.

Migration: ``export_swap`` serializes a swap entry into a portable blob
(a self-described npz: a JSON meta record with the cache's geometry and
the page plan, plus the host page arrays; bf16 pages travel as their
uint16 bit patterns, which the meta record states), and
``import_swap`` adopts one into this cache's host pool.  ``rollback``
un-appends a slot's last tokens (host-side length only).

Telemetry: the reference's ``kv_cache_*`` counters and gauges (pages
allocated and released, OOMs, utilization, prefix evictions,
copy-on-write copies, swap traffic) in the observability registry under
the label ``cache=<id>``, counted at the same sites; ``metrics_snapshot``,
``memory_rows`` (the ``/memz`` row), ``page_utilization``,
``free_page_count`` and ``kv_bytes_per_token`` read them, all host-side.
``write_prefill`` bulk-writes a prompt's K/V into a slot's pages (a plain
scatter, quantized per row for int8 pools).

Tensor-parallel pools (``shardings``: a ``distributed.sharding.
TPShardings`` plan): each rank's pools (and int8 scale pools) hold its
``n_kv_heads / tp`` KV heads of every page on dim 1, so the host
bookkeeping (free list, page tables, lengths, prefix index, swap plans)
stays global and identical on every rank, which makes the same calls in
the same order.  ``swap_out`` / ``swap_in`` move the rank's heads only;
``export_swap`` gathers the entry's pages of all heads over the mesh (on
the cache's device: NCCL gathers device tensors) into the blob a
single-card cache writes, and ``import_swap`` keeps the rank's heads,
so a blob moves between mesh shapes.  ``export_swap`` is collective
under a mesh: every rank calls it for the same handle.
"""
from __future__ import annotations

import hashlib
import io
import itertools
import json
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..common.errors import enforce
from ..distributed.collective import all_gather_concat
from ..observability import get_registry
from ..ops.paged_attention import (paged_attention, paged_write,
                                   paged_write_quant)
from ..quantization.ops import quantize_rows
from ..runtime.device import resolve_device

__all__ = ["PagedKVCache"]

_CACHE_IDS = itertools.count()


def _chain_hash(prev: bytes, tokens) -> bytes:
    """Key for one full token block given the previous block's key."""
    h = hashlib.blake2b(prev, digest_size=16)
    h.update(np.asarray(tokens, np.int64).tobytes())
    return h.digest()


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


class _SwapEntry:
    """Host-side record of one swapped-out sequence: per written page
    either ("data", j) — row j of the host page arrays [L, KVH, j, P, D]
    holds a private page's bytes — or ("key", chain_key) — a shared
    prefix page to re-pin through the index at swap-in time."""

    __slots__ = ("plan", "k_host", "v_host", "k_scale_host",
                 "v_scale_host", "n_host_pages")

    def __init__(self, plan, k_host, v_host, k_scale_host, v_scale_host):
        self.plan = plan
        self.k_host = k_host
        self.v_host = v_host
        self.k_scale_host = k_scale_host
        self.v_scale_host = v_scale_host
        self.n_host_pages = 0 if k_host is None else k_host.shape[2]


class PagedKVCache:
    def __init__(self, n_pages: int, page_size: int, n_kv_heads: int,
                 head_dim: int, max_seqs: int, max_len: int,
                 dtype: torch.dtype = torch.float32, num_layers: int = 1,
                 kv_dtype: Optional[str] = None, swap_pool_pages: int = 0,
                 device=None, shardings=None):
        enforce(kv_dtype in (None, "int8"),
                f"unsupported kv_dtype {kv_dtype!r} (None or 'int8')")
        self.device = resolve_device(device)
        self._shardings = shardings
        self.tp = 1 if shardings is None else shardings.tp
        enforce(n_kv_heads % self.tp == 0,
                f"tp={self.tp} must divide n_kv_heads ({n_kv_heads})")
        self.n_kv_heads = n_kv_heads
        self.n_pages = n_pages
        self.page_size = page_size
        self.num_layers = num_layers
        self.kv_dtype = kv_dtype
        self.max_pages_per_seq = (max_len + page_size - 1) // page_size
        # [L, KVH / tp, n_pages, P, D]: this rank's heads
        self.k_pages = torch.zeros(
            (num_layers, n_kv_heads // self.tp, n_pages, page_size,
             head_dim),
            dtype=torch.int8 if kv_dtype == "int8" else dtype,
            device=self.device)
        self.v_pages = torch.zeros_like(self.k_pages)
        # int8 pools: one f32 dequantization scale per token row
        self.k_scales = self.v_scales = None
        if kv_dtype == "int8":
            self.k_scales = torch.zeros(
                (num_layers, n_kv_heads // self.tp, n_pages, page_size),
                dtype=torch.float32, device=self.device)
            self.v_scales = torch.zeros_like(self.k_scales)
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
        # swap: a bounded host pool of page copies for preempted
        # sequences (0 pages: swap disabled, resume recomputes)
        self.swap_pool_pages = int(swap_pool_pages)
        self._swap: Dict[int, _SwapEntry] = {}
        self._swap_used = 0
        self._swap_ids = itertools.count()
        self._init_metrics()

    def _init_metrics(self):
        """This cache's children of the reference's ``kv_cache_*``
        series (label cache=<id>, so concurrent engines scrape apart)."""
        reg = get_registry()
        self.cache_id = str(next(_CACHE_IDS))
        lbl = ("cache",)

        def counter(name, help):
            return reg.counter(name, help, lbl).labels(self.cache_id)

        def gauge(name, help):
            return reg.gauge(name, help, lbl).labels(self.cache_id)

        self._m_alloc = counter(
            "kv_cache_pages_allocated_total",
            "KV pages taken from the free list.")
        self._m_release = counter(
            "kv_cache_pages_released_total",
            "KV pages returned to the free list.")
        self._m_oom = counter(
            "kv_cache_oom_total",
            "Allocation/extension failures: not enough free pages.")
        self._m_util = gauge(
            "kv_cache_page_utilization",
            "Fraction of usable pages referenced by live slots (page 0 "
            "is the reserved pad page; prefix-cached LRU pages count "
            "as reclaimable, not in use).")
        self._m_evict = counter(
            "kv_cache_prefix_evicted_pages_total",
            "Prefix-cached pages evicted from the LRU pool under page "
            "pressure.")
        self._m_cow = counter(
            "kv_cache_cow_pages_total",
            "Copy-on-write page copies (a write targeted a shared "
            "page).")
        self._m_cached = gauge(
            "kv_cache_prefix_cached_pages",
            "Registered prefix pages currently unreferenced (the LRU "
            "pool).")
        self._m_swap_out = counter(
            "kv_cache_swap_out_pages_total",
            "Device pages copied to the host swap pool by swap_out "
            "(shared prefix pages are unpinned, not copied).")
        self._m_swap_in = counter(
            "kv_cache_swap_in_pages_total",
            "Host pages copied back to device pages by swap_in.")
        self._m_swap_fallback = counter(
            "kv_cache_swap_fallback_total",
            "swap_out/swap_in attempts that degraded to the recompute "
            "path (pool full or disabled, entry dropped, or a shared "
            "prefix page evicted while suspended).")
        self._m_swap_pool = gauge(
            "kv_cache_swap_pool_pages",
            "Host swap-pool pages currently holding preempted KV.")
        self._m_swap_export = counter(
            "kv_cache_swap_exported_pages_total",
            "Swap-pool pages serialized into portable migration blobs "
            "(export_swap).")
        self._m_swap_import = counter(
            "kv_cache_swap_imported_pages_total",
            "Swap-pool pages restored from portable migration blobs "
            "(import_swap).")

    def page_utilization(self) -> float:
        """Referenced fraction of the usable pool (pad page 0 excluded;
        prefix-cached LRU pages count as reclaimable)."""
        usable = self.n_pages - 1
        if not usable:
            return 0.0
        return 1.0 - (len(self._free) + len(self._lru)) / usable

    def _track_pages(self):
        self._m_util.set(self.page_utilization())
        self._m_cached.set(len(self._lru))

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
            self._m_evict.inc()
        else:
            self._m_oom.inc()
            self._track_pages()
            enforce(False, f"paged cache OOM on {what}: no free or "
                           f"evictable pages")
        self._m_alloc.inc()
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

    def _pools(self):
        """(k, v, k_scales, v_scales) pools; the scales None for float."""
        return self.k_pages, self.v_pages, self.k_scales, self.v_scales

    def _copy_page(self, src: int, dst: int):
        """Copy one physical page in every layer, K and V (and their
        scale rows in int8 mode: scales travel with their pages)."""
        for pool in self._pools():
            if pool is not None:
                pool[:, :, dst] = pool[:, :, src]

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
            self._m_release.inc()
            self._pages[slot][idx] = npg
            self._table[slot, idx] = npg
            self._m_cow.inc()
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
            self._m_oom.inc()
            for pg in reversed(shared):
                self._unref(pg)
            self._track_pages()
            enforce(False,
                    f"paged cache OOM: need {need - len(shared)} "
                    f"pages, {avail} free/evictable")
        self._m_alloc.inc(len(shared))      # the shared references
        pages = shared + [self._grab_page("allocate")
                          for _ in range(need - len(shared))]
        self._used[slot] = True
        self._pages[slot] = pages
        self._lens[slot] = 0
        self._table[slot, :] = 0
        self._table[slot, :need] = pages
        self._track_pages()
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
        self._track_pages()

    def release(self, slot: int):
        """Drop the slot's page references.  Unregistered pages return
        to the free list; registered ones park in the LRU pool."""
        pages = self._pages.pop(slot)
        for pg in reversed(pages):
            self._unref(pg)
        self._m_release.inc(len(pages))
        self._used[slot] = False
        self._lens[slot] = 0
        self._table[slot, :] = 0
        self._track_pages()

    # -- KV swap (preemption) --------------------------------------------------
    def _to_host(self, sel: List[int]):
        """Host copies [L, KVH, len(sel), ...] of the pages ``sel`` of
        every pool (None for absent scale pools), through pinned memory
        on a CUDA cache.  The copies are complete on return."""
        idx = torch.as_tensor(sel, dtype=torch.long, device=self.device)
        pin = self.device.type == "cuda"
        out = []
        for pool in self._pools():
            if pool is None:
                out.append(None)
                continue
            rows = pool[:, :, idx]
            host = torch.empty(rows.shape, dtype=rows.dtype,
                               pin_memory=pin)
            host.copy_(rows)                  # synchronous: complete here
            out.append(host)
        return out

    def swap_out(self, slot: int) -> Optional[int]:
        """Preempt ``slot``: copy its private written pages (and int8
        scale rows) into the host swap pool, then release every device
        page it holds.  Shared prefix pages are not copied, only
        unpinned; their chain keys are recorded so ``swap_in`` can re-pin
        them (registered pages are immutable).

        Returns a swap handle for ``swap_in``, or ``None`` when the
        bounded pool cannot hold the private pages (or swap is disabled):
        the slot is released either way, and the caller recomputes."""
        P = self.page_size
        written = -(-int(self._lens[slot]) // P)
        pages = self._pages[slot]
        plan: List[tuple] = []
        data_pages: List[int] = []
        for i in range(written):
            pg = pages[i]
            if pg in self._page_key:
                plan.append(("key", self._page_key[pg]))
            else:
                plan.append(("data", len(data_pages)))
                data_pages.append(pg)
        handle = None
        if self.swap_pool_pages and \
                self._swap_used + len(data_pages) <= self.swap_pool_pages:
            # the host copies complete before the pages return to the
            # free list and can be overwritten
            host = self._to_host(data_pages) if data_pages \
                else [None] * 4
            handle = next(self._swap_ids)
            self._swap[handle] = _SwapEntry(plan, *host)
            self._swap_used += len(data_pages)
            self._m_swap_out.inc(len(data_pages))
            self._m_swap_pool.set(self._swap_used)
        else:
            self._m_swap_fallback.inc()
        self.release(slot)
        return handle

    def swap_in(self, handle: int, n_tokens: int) -> Optional[int]:
        """Restore a swapped-out sequence into a fresh slot with its full
        ``n_tokens`` page budget re-reserved: shared prefix pages re-pinned
        through the index, private pages written back from the host pool,
        the unwritten remainder freshly grabbed.  The caller sets the
        length.

        Returns the new slot, or ``None`` when the entry cannot be
        restored (dropped, a shared prefix page evicted while suspended,
        or too few free/evictable pages).  The handle is consumed either
        way: on ``None`` the caller recomputes."""
        entry = self._swap.pop(handle, None)
        if entry is None:
            self._m_swap_fallback.inc()
            return None

        def _drop(shared_pinned=()):
            for pg in list(shared_pinned)[::-1]:
                self._unref(pg)
            self._swap_used -= entry.n_host_pages
            self._m_swap_pool.set(self._swap_used)
            self._m_swap_fallback.inc()
            self._track_pages()
            return None

        # resolve the shared chain keys first: a miss means the prefix
        # page was evicted while the sequence was suspended
        shared: List[int] = []
        for kind, val in entry.plan:
            if kind == "key":
                pg = self._index.get(val)
                if pg is None:
                    return _drop()
                shared.append(pg)
        free_slots = [i for i, u in enumerate(self._used) if not u]
        if not free_slots:
            return _drop()
        slot = free_slots[0]
        need = -(-n_tokens // self.page_size)
        enforce(need >= len(entry.plan),
                f"swap_in budget {need} pages < {len(entry.plan)} written "
                f"pages")
        # pin the shared pages first, as allocate does
        for pg in shared:
            self._ref[pg] += 1
            if pg in self._lru:
                del self._lru[pg]
        if len(self._free) + len(self._lru) < need - len(shared):
            return _drop(shared)
        self._m_alloc.inc(len(shared))
        sit = iter(shared)
        pages: List[int] = []
        restore: List[tuple] = []              # (device page, host row)
        for kind, val in entry.plan:
            if kind == "key":
                pages.append(next(sit))
            else:
                pg = self._grab_page("swap-in")
                pages.append(pg)
                restore.append((pg, val))
        pages += [self._grab_page("swap-in")
                  for _ in range(need - len(entry.plan))]
        if restore:
            sel = torch.as_tensor([pg for pg, _ in restore],
                                  dtype=torch.long, device=self.device)
            src = torch.as_tensor([j for _, j in restore], dtype=torch.long)
            hosts = (entry.k_host, entry.v_host, entry.k_scale_host,
                     entry.v_scale_host)
            for pool, host in zip(self._pools(), hosts):
                if pool is not None:
                    pool[:, :, sel] = host[:, :, src].to(self.device)
        self._used[slot] = True
        self._pages[slot] = pages
        self._lens[slot] = 0                   # the caller set_len()s
        self._table[slot, :] = 0
        self._table[slot, :need] = pages
        self._swap_used -= entry.n_host_pages
        self._m_swap_in.inc(len(restore))
        self._m_swap_pool.set(self._swap_used)
        self._track_pages()
        return slot

    def drop_swap(self, handle: Optional[int]) -> bool:
        """Free a swap entry without restoring it (abort of a suspended
        request).  ``None`` and consumed handles are no-ops."""
        entry = self._swap.pop(handle, None) if handle is not None \
            else None
        if entry is None:
            return False
        self._swap_used -= entry.n_host_pages
        self._m_swap_pool.set(self._swap_used)
        return True

    def swap_pool_used(self) -> int:
        """Host swap-pool pages currently holding preempted KV."""
        return self._swap_used

    # -- KV migration ----------------------------------------------------------
    def _swap_geometry(self) -> dict:
        """The shape contract a migration blob must match (other
        geometry would reinterpret page bytes)."""
        return {"page_size": self.page_size,
                "num_layers": self.num_layers,
                "n_kv_heads": int(self.n_kv_heads),
                "head_dim": int(self.k_pages.shape[-1]),
                "kv_dtype": self.kv_dtype or "",
                "pool_dtype": _dtype_name(self.k_pages.dtype)}

    def export_swap(self, handle: Optional[int]) -> Optional[bytes]:
        """Serialize one swap entry into a portable blob: an npz of a
        JSON meta record (the geometry, the page plan with chain keys in
        hex, the host page count, and ``bits_as``: the arrays that hold
        bf16 pages as uint16 bit patterns) plus the host page arrays.
        The entry is consumed.  Shared-prefix plan entries whose key
        still resolves here travel as page data (registered pages are
        immutable), the rest as keys.  ``None`` and consumed handles
        return ``None``.  Under a mesh every rank calls it with the same
        handle: the pages of all heads are gathered (a collective)."""
        entry = self._swap.pop(handle, None) if handle is not None \
            else None
        if entry is None:
            return None
        self._swap_used -= entry.n_host_pages
        self._m_swap_pool.set(self._swap_used)
        n_data = entry.n_host_pages
        extra: List[int] = []
        plan: List[tuple] = []
        for kind, val in entry.plan:
            if kind == "key":
                pg = self._index.get(val)
                if pg is not None:
                    plan.append(("data", n_data + len(extra)))
                    extra.append(pg)
                    continue
            plan.append((kind, val))
        hosts = [entry.k_host, entry.v_host, entry.k_scale_host,
                 entry.v_scale_host]
        if extra:
            more = self._to_host(extra)
            hosts = [m if h is None else (None if m is None else
                                          torch.cat([h, m], dim=2))
                     for h, m in zip(hosts, more)]
        if self._shardings is not None:
            # every head of the entry's pages, as one card's cache holds
            # them: gathered on the device (NCCL takes device tensors)
            hosts = [None if h is None else all_gather_concat(
                h.to(self.device), 1, self._shardings.group).cpu()
                for h in hosts]
        meta = dict(self._swap_geometry())
        meta["plan"] = [["key", val.hex()] if kind == "key"
                        else ["data", int(val)] for kind, val in plan]
        meta["n_host_pages"] = n_data + len(extra)
        meta["bits_as"] = {}
        arrays = {}
        for name, h in zip(("k_host", "v_host", "k_scale_host",
                            "v_scale_host"), hosts):
            if h is None:
                continue
            if h.dtype == torch.bfloat16:       # numpy has no bfloat16
                meta["bits_as"][name] = [_dtype_name(h.dtype), "uint16"]
                arrays[name] = h.view(torch.int16).numpy().view(np.uint16)
            else:
                arrays[name] = h.numpy()
        arrays["meta"] = np.frombuffer(json.dumps(meta).encode("utf-8"),
                                       np.uint8)
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        self._m_swap_export.inc(meta["n_host_pages"])
        return buf.getvalue()

    def import_swap(self, blob: Optional[bytes]) -> Optional[int]:
        """Adopt a migration blob into this cache's host pool; returns a
        handle ``swap_in`` takes.  A geometry mismatch raises; a pool
        that cannot hold the blob's pages returns ``None`` (the caller
        resumes by recomputing)."""
        if blob is None:
            return None
        with np.load(io.BytesIO(blob)) as z:
            meta = json.loads(bytes(z["meta"]).decode("utf-8"))
            for k, v in self._swap_geometry().items():
                enforce(meta.get(k) == v,
                        f"migration blob geometry mismatch: {k} is "
                        f"{meta.get(k)!r}, this cache has {v!r}")
            hosts = []
            for name in ("k_host", "v_host", "k_scale_host",
                         "v_scale_host"):
                if name not in z:
                    hosts.append(None)
                    continue
                a = np.array(z[name])
                if name in meta.get("bits_as", {}):
                    dt = getattr(torch, meta["bits_as"][name][0])
                    hosts.append(torch.from_numpy(a.view(np.int16)).view(dt))
                else:
                    hosts.append(torch.from_numpy(a))
        if self._shardings is not None:
            # the blob holds every head: keep this rank's
            hosts = [self._shardings.put(h, 1) for h in hosts]
        n_host = int(meta["n_host_pages"])
        if not self.swap_pool_pages or \
                self._swap_used + n_host > self.swap_pool_pages:
            self._m_swap_fallback.inc()
            return None
        plan = [("key", bytes.fromhex(val)) if kind == "key"
                else ("data", int(val)) for kind, val in meta["plan"]]
        handle = next(self._swap_ids)
        self._swap[handle] = _SwapEntry(plan, *hosts)
        self._swap_used += n_host
        self._m_swap_import.inc(n_host)
        self._m_swap_pool.set(self._swap_used)
        return handle

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
        self._track_pages()
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

    def rollback(self, slot: int, n: int):
        """Un-append the last ``n`` tokens of ``slot``: a host-side
        length decrement and nothing else.  The rows stay in the pages
        but are never attended (every path masks at the length) and the
        next append overwrites them; the pages stay attached."""
        n = int(n)
        enforce(n >= 0, f"rollback of {n} tokens")
        enforce(self._used[slot], f"rollback on free slot {slot}")
        enforce(self._lens[slot] >= n,
                f"rollback of {n} tokens but slot {slot} holds "
                f"{int(self._lens[slot])}")
        self._lens[slot] -= n

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

    def free_page_count(self) -> int:
        """Allocatable pages: the free list plus the prefix-cached LRU
        pool (the reference's name of ``free_pages``)."""
        return self.free_pages()

    def free_slot_count(self) -> int:
        """Sequence slots not currently bound to a live request."""
        return sum(1 for u in self._used if not u)

    def kv_bytes_per_token(self) -> int:
        """Device bytes one cached token costs across all layers and
        both pools (int8 counts its f32 scale per row)."""
        head_dim = self.k_pages.shape[-1]
        kvh = self.n_kv_heads
        if self.kv_dtype == "int8":
            per_row = head_dim * 1 + 4          # int8 values + f32 scale
        else:
            per_row = head_dim * self.k_pages.element_size()
        return 2 * self.num_layers * kvh * per_row

    def metrics_snapshot(self) -> dict:
        """This cache's page-pressure counters (the same series are in
        the registry under label cache=<id>)."""
        return {"pages_allocated": int(self._m_alloc.value),
                "pages_released": int(self._m_release.value),
                "oom_events": int(self._m_oom.value),
                "free_pages": self.free_page_count(),
                "page_utilization": self.page_utilization(),
                "prefix_cached_pages": self.cached_page_count(),
                "prefix_shared_pages": self.shared_page_count(),
                "prefix_evicted_pages": int(self._m_evict.value),
                "cow_pages": int(self._m_cow.value),
                "swap_pool_pages": self.swap_pool_pages,
                "swap_pool_used": self._swap_used,
                "swap_out_pages": int(self._m_swap_out.value),
                "swap_in_pages": int(self._m_swap_in.value),
                "swap_exported_pages": int(self._m_swap_export.value),
                "swap_imported_pages": int(self._m_swap_import.value),
                "swap_fallbacks": int(self._m_swap_fallback.value)}

    def memory_rows(self) -> dict:
        """The memory plane's row (``observability.introspection``):
        bytes the device pools hold (values and int8 scale planes) and
        the bytes of this process's host swap pool page copies.  Under a
        mesh ``device_bytes`` is the whole model-side pool, as the
        reference reports it (a tp 4 replica must not look 4 times
        cheaper), ``device_bytes_per_shard`` what one card holds, and
        ``tp`` the divisor."""
        shard = sum(int(t.nbytes) for t in self._pools() if t is not None)
        dev = shard * self.tp
        host = 0
        for entry in self._swap.values():
            for arr in (entry.k_host, entry.v_host,
                        entry.k_scale_host, entry.v_scale_host):
                if arr is not None:
                    host += int(arr.nbytes)
        return {"device_bytes": dev,
                "device_bytes_per_shard": shard,
                "tp": self.tp,
                "host_bytes": host,
                "pages": int(self.n_pages),
                "free_pages": self.free_page_count(),
                "bytes_per_token": self.kv_bytes_per_token(),
                "swap_pool_pages": int(self.swap_pool_pages),
                "swap_pool_used": int(self._swap_used)}

    # -- device-side ops -------------------------------------------------------
    def scales(self, layer: int):
        """One layer's (k_scales, v_scales) [KVH, n_pages, P] views, or
        (None, None) for float pools."""
        if self.k_scales is None:
            return None, None
        return self.k_scales[layer], self.v_scales[layer]

    def write_prefill(self, slot: int, k, v):
        """Bulk-write a prompt's keys/values after the slot's current
        length: k/v [S, KVH, D] (one layer) or [L, S, KVH, D] in the
        model's dtype.  One scatter a pool (int8 pools quantize each row
        and scatter its scale beside), then the length advances by S.
        Plain PyTorch on either device, the reference's jnp body."""
        if k.dim() == 3:
            enforce(self.num_layers == 1,
                    f"cache holds {self.num_layers} layers; pass "
                    f"[L, ...] keys/values")
            k, v = k[None], v[None]
        s = k.shape[1]
        self.extend(slot, s)
        start = int(self._lens[slot])
        pos = np.arange(start, start + s)
        pages = torch.as_tensor(self._table[slot, pos // self.page_size],
                                dtype=torch.long, device=self.device)
        rows = torch.as_tensor(pos % self.page_size, dtype=torch.long,
                               device=self.device)
        # [L, S, KVH, D] -> [L, KVH, S, D], scattered at (pages, rows)
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        if self.kv_dtype == "int8":
            kt, ksc = quantize_rows(kt)         # + [L, KVH, S] scales
            vt, vsc = quantize_rows(vt)
            self.k_scales[:, :, pages, rows] = ksc
            self.v_scales[:, :, pages, rows] = vsc
        self.k_pages[:, :, pages, rows, :] = kt.to(self.k_pages.dtype)
        self.v_pages[:, :, pages, rows, :] = vt.to(self.v_pages.dtype)
        self._lens[slot] = start + s

    def append(self, slots, k_new, v_new):
        """Decode step: one new token for each sequence in ``slots``.
        k_new/v_new [L, B, KVH, D] (or [B, KVH, D] for one layer), in the
        model's dtype; int8 pools quantize each row per token.  Lengths
        advance by 1, once across all layers."""
        if k_new.dim() == 3:
            enforce(self.num_layers == 1,
                    f"cache holds {self.num_layers} layers; pass "
                    f"[L, ...] keys/values")
            k_new, v_new = k_new[None], v_new[None]
        slots = np.atleast_1d(slots)
        for s in slots:
            self.extend(int(s), 1)
        table = torch.as_tensor(self._table[slots], device=self.device)
        lens = torch.as_tensor(self._lens[slots], device=self.device)
        for layer in range(self.num_layers):
            kp, vp = self.k_pages[layer], self.v_pages[layer]
            if self.k_scales is None:
                paged_write(kp, vp, k_new[layer], v_new[layer], table, lens)
            else:
                paged_write_quant(kp, vp, *self.scales(layer), k_new[layer],
                                  v_new[layer], table, lens)
        self.advance(slots, 1)

    def attend(self, slots, q, layer: int = 0):
        """Decode attention of ``q`` [B, H, D] over the cached tokens of
        ``slots`` in ``layer``: kernel #6 on CUDA tensors, its plain
        version on CPU tensors (the tensors' device decides; int8 pools
        hand their scale pools to either)."""
        slots = np.atleast_1d(slots)
        table = torch.as_tensor(self._table[slots], device=self.device)
        lens = torch.as_tensor(self._lens[slots], device=self.device)
        return paged_attention(q, self.k_pages[layer], self.v_pages[layer],
                               table, lens, *self.scales(layer))
