"""LLMEngine — continuous-batching serving loop over the paged KV cache.

Counterpart of ``paddle_tpu/inference/engine.py`` for the Llama serving
path.  Requests of ragged lengths share one page pool
(``inference/paged_cache.py``); host-side work per step is page-table
bookkeeping and the packing of one flat token batch.

``step()`` is the ragged unified step: one forward over a flat batch of
``T = max_seqs + prefill_token_budget`` rows that carries every active
decode slot (one row each) plus pending ``begin_request`` prefill
chunks, packed up to the prefill budget without crossing page
boundaries.  Each layer's attention is one call of the ragged kernel
(``ops/paged_attention.py``): it appends every row's K/V into its page
and attends each row over its own sequence, so prefill rides beside
decode instead of stalling it.  ``steps_per_sync > 1`` runs pure-decode
windows as host-chained single-token steps, the reference's
``scan_decode=False`` order, which the reference holds bit-identical to
its on-device window.

``add_request`` is the synchronous admission path: the prompt runs in
page-sized chunks, each writing one whole page and attending over the
sequence's pages so far through the flash-forward kernel
(``ops/flash_attention.py``) under an additive position mask; the first
token comes back at once.

Automatic prefix caching: admission looks up the longest cached
page-aligned prefix of the prompt, maps those pages into the new slot
(host-side only) and prefills only the tail.

Greedy decoding only.  Knobs of the reference engine that this port does
not take yet raise ``NotImplementedError`` naming their ROADMAP item;
metrics, tracing and request capsules are not ported.

Weights are read per layer from the model's own parameters (no stacked
copy), and the engine runs on the model's device: the GPU by default,
the CPU only when the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..common.errors import enforce
from ..models.llama import _rotate_half
from ..nn.generation import sample_logits
from ..ops import _nn
from ..ops.flash_attention import flash_attention_raw
from ..ops.paged_attention import ragged_paged_append_attend
from ..runtime.device import resolve_device
from .backbone import resolve_backbone
from .paged_cache import PagedKVCache

__all__ = ["LLMEngine", "GenRequest"]


class GenRequest:
    def __init__(self, rid, prompt_ids, max_new_tokens, eos_token_id):
        self.rid = rid
        self.prompt = list(prompt_ids)
        self.max_new = max_new_tokens
        self.eos = eos_token_id
        self.out: List[int] = []
        self.slot: Optional[int] = None
        self.done = False
        self.cancelled = False
        # deferred admission (begin_request): next prompt position to
        # prefill
        self.pf_pos = 0


def _rope(x, cos, sin):
    """Rotary embedding in f32, cast back to x's dtype."""
    xf = x.float()
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)


def _head(x, head_w, tied):
    return x @ head_w.T if tied else x @ head_w


def _ffn(x, pln, gw, uw, dw, eps):
    hn = _nn.rms_norm(x, pln, epsilon=eps)
    return x + (_nn.silu(hn @ gw) * (hn @ uw)) @ dw


@torch.no_grad()
def _paged_prefill_chunk(layers, norm_w, head_w, embed_w, rope,
                         k_pages, v_pages, ids, table, prev_len: int,
                         page_slot: int, last_in_chunk: int, *,
                         eps: float, kvh: int, head_dim: int,
                         tied: bool):
    """Chunked prefill of ``ids`` [C] — one page-sized chunk of one
    prompt — against the paged cache.  The chunk's K/V fill exactly one
    page (``page_slot``; C == page_size), written whole, and its queries
    attend over all of the sequence's pages (``table`` [maxp]) through
    the flash kernel under an additive mask: chunk row r (position
    prev_len + r) sees kv positions <= prev_len + r.  The pools are
    updated in place.  ``last_in_chunk`` is the row whose logits matter
    on the final chunk.  Returns logits [V]."""
    cos_t, sin_t = rope
    c = ids.shape[0]
    maxp = table.shape[0]
    s_kv = maxp * c
    x = embed_w[ids]                                   # [C, H]
    cos = cos_t[prev_len:prev_len + c][:, None, :]
    sin = sin_t[prev_len:prev_len + c][:, None, :]
    kvpos = torch.arange(s_kv, device=ids.device)
    allow = kvpos[None, :] <= prev_len + torch.arange(
        c, device=ids.device)[:, None]
    amask = torch.zeros(allow.shape, dtype=torch.float32,
                        device=ids.device).masked_fill_(~allow, -1e30)
    for li, (iln, qw, kw, vw, ow, pln, gw, uw, dw) in enumerate(layers):
        kp, vp = k_pages[li], v_pages[li]
        hn = _nn.rms_norm(x, iln, epsilon=eps)
        nh = qw.shape[-1] // head_dim
        q = _rope((hn @ qw).view(c, nh, head_dim), cos, sin)
        k = _rope((hn @ kw).view(c, kvh, head_dim), cos, sin)
        v = (hn @ vw).view(c, kvh, head_dim)
        # whole-page write: [C, KVH, D] -> page [KVH, C(=P), D]
        kp[:, page_slot] = k.transpose(0, 1)
        vp[:, page_slot] = v.transpose(0, 1)
        # this sequence's pages, chunk included, as [S_kv, KVH, D] views
        k_full = kp[:, table].reshape(kvh, s_kv, head_dim).transpose(0, 1)
        v_full = vp[:, table].reshape(kvh, s_kv, head_dim).transpose(0, 1)
        attn = flash_attention_raw(q[None], k_full[None], v_full[None],
                                   causal=False, mask=amask[None, None])[0]
        x = x + attn.reshape(c, nh * head_dim) @ ow
        x = _ffn(x, pln, gw, uw, dw, eps)
    x = _nn.rms_norm(x, norm_w, epsilon=eps)
    return _head(x[last_in_chunk], head_w, tied)


@torch.no_grad()
def _mixed_forward(layers, norm_w, head_w, embed_w, rope, k_pages,
                   v_pages, ids, positions, q_start, q_len, kv_len,
                   desc_tables, desc_of_row, off_of_row, *, eps: float,
                   kvh: int, head_dim: int, tied: bool):
    """One forward of the ragged unified step over a flat batch of T
    rows: every row appends its K/V at its own position and attends over
    its own sequence's pages (the ragged kernel, pools updated in
    place); descriptor outputs gather back to flat rows through
    (desc_of_row, off_of_row).  ids/positions [T]; q_start/q_len/kv_len
    [S] and desc_tables [S, maxp] int32 with ``q_len == 0`` marking
    unused descriptors.  Returns logits [T, V]."""
    cos_t, sin_t = rope
    t = ids.shape[0]
    x = embed_w[ids]                                   # [T, H]
    cos = cos_t[positions][:, None, :]                 # [T, 1, D]
    sin = sin_t[positions][:, None, :]
    for li, (iln, qw, kw, vw, ow, pln, gw, uw, dw) in enumerate(layers):
        hn = _nn.rms_norm(x, iln, epsilon=eps)
        nh = qw.shape[-1] // head_dim
        q = _rope((hn @ qw).view(t, nh, head_dim), cos, sin)
        k = _rope((hn @ kw).view(t, kvh, head_dim), cos, sin)
        v = (hn @ vw).view(t, kvh, head_dim)
        blocks = ragged_paged_append_attend(
            q, k_pages[li], v_pages[li], k.to(k_pages.dtype),
            v.to(v_pages.dtype), q_start, q_len, kv_len, desc_tables)
        attn = blocks[desc_of_row, off_of_row]         # [T, NH, D]
        x = x + attn.reshape(t, nh * head_dim) @ ow
        x = _ffn(x, pln, gw, uw, dw, eps)
    x = _nn.rms_norm(x, norm_w, epsilon=eps)
    return _head(x, head_w, tied)


class LLMEngine:
    """Continuous batching for Llama-family models (greedy decoding).

    ``dtype`` is the KV pools' dtype; ``None`` takes the model's weight
    dtype.
    ``device`` defaults to the GPU and must hold the model."""

    def __init__(self, model, max_seqs: int = 8, max_len: int = 2048,
                 page_size: int = 128, n_pages: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None,
                 decode_strategy: str = "greedy_search",
                 steps_per_sync: int = 1,
                 kv_dtype: Optional[str] = None,
                 weight_dtype: Optional[str] = None,
                 enable_prefix_caching: bool = True,
                 unified_step: bool = True,
                 prefill_token_budget: Optional[int] = None,
                 mesh=None, draft_model=None, device=None):
        todo = {
            "kv_dtype='int8'": (kv_dtype == "int8", "Port slice 2"),
            "weight_dtype": (weight_dtype is not None, "Port slice 2"),
            "unified_step=False": (not unified_step, "Port slice 2"),
            "decode_strategy='sampling'": (
                decode_strategy == "sampling", "Port: remaining modules"),
            "mesh (tensor-parallel serving)": (
                mesh is not None, "Port: remaining modules"),
            "draft_model (speculative decoding)": (
                draft_model is not None, "Port: remaining modules"),
        }
        for knob, (asked, item) in todo.items():
            if asked:
                raise NotImplementedError(
                    f"LLMEngine {knob} is not ported yet (ROADMAP "
                    f"'{item}')")
        enforce(decode_strategy == "greedy_search",
                f"unsupported decode_strategy {decode_strategy!r}")
        enforce(kv_dtype is None,
                f"unsupported kv_dtype {kv_dtype!r}; pass the pool dtype "
                f"as dtype=")
        enforce(steps_per_sync >= 1, "steps_per_sync must be >= 1")
        self.device = resolve_device(device)
        spec = resolve_backbone(model)
        c = spec.config
        self.config = c
        embed = spec.embed_tokens.weight
        enforce(embed.device == self.device,
                f"model parameters live on {embed.device}, the engine on "
                f"{self.device}")
        dtype = embed.dtype if dtype is None else dtype
        if self.device.type == "cuda" and dtype != embed.dtype:
            raise NotImplementedError(
                f"KV pools in {dtype} under {embed.dtype} weights: the "
                f"ragged kernel takes one dtype (ROADMAP 'Port slice 2')")
        self.steps_per_sync = steps_per_sync
        self.decode_strategy = decode_strategy
        self.max_seqs = max_seqs
        self.max_len = max_len
        self.enable_prefix_caching = bool(enable_prefix_caching)
        # the static prefill budget sizes the flat batch (T = max_seqs +
        # budget rows); the runtime ``prefill_token_budget`` attribute
        # may be lowered per step without changing T
        self._pf_budget_static = int(prefill_token_budget) \
            if prefill_token_budget is not None else page_size
        enforce(self._pf_budget_static >= 1,
                "prefill_token_budget must be >= 1")
        self.prefill_token_budget = self._pf_budget_static
        self._prefilling: List[GenRequest] = []
        self.prefix_stats = {"hit_tokens": 0, "miss_tokens": 0,
                             "shared_pages": 0, "hit_requests": 0,
                             "miss_requests": 0}
        self.eps = c.rms_norm_eps
        self.kvh = c.num_key_value_heads
        self.head_dim = c.hidden_size // c.num_attention_heads
        if n_pages is None:
            n_pages = max_seqs * (max_len // page_size) + 1
        self.cache = PagedKVCache(
            n_pages=n_pages, page_size=page_size, n_kv_heads=self.kvh,
            head_dim=self.head_dim, max_seqs=max_seqs, max_len=max_len,
            dtype=dtype, num_layers=len(spec.layers), device=self.device)
        # per-layer references to the model's own weights: a stacked
        # copy would duplicate every weight (16 GB at 8B)
        self._layers = [
            (l.input_layernorm.weight, l.self_attn.q_proj.weight,
             l.self_attn.k_proj.weight, l.self_attn.v_proj.weight,
             l.self_attn.o_proj.weight, l.post_attention_layernorm.weight,
             l.mlp.gate_proj.weight, l.mlp.up_proj.weight,
             l.mlp.down_proj.weight) for l in spec.layers]
        self._norm_w = spec.norm.weight
        self._tied = spec.lm_head is None
        self._embed_w = embed
        self._head_w = embed if self._tied else spec.lm_head.weight
        self._rope = (spec.rope_cos.float(), spec.rope_sin.float())
        # the chunked prefill slices a full page of rope rows at the
        # last chunk's base: pad the tables to a page multiple so the
        # slice never runs short (padded rows back padding ids only)
        maxpos = self._rope[0].shape[0]
        pad_to = -(-max(maxpos, page_size) // page_size) * page_size
        self._rope_prefill = tuple(
            torch.nn.functional.pad(r, (0, 0, 0, pad_to - maxpos))
            for r in self._rope)
        self.requests: Dict[object, GenRequest] = {}
        self._active: List[GenRequest] = []

    # -- internals -------------------------------------------------------------
    def _dev(self, a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=self.device)

    def _prefill_seq(self, slot, seq, start_chunk: int):
        """Run the chunked prefill over ``seq`` in ``slot`` from chunk
        ``start_chunk`` on (earlier chunks' pages are already written —
        the prefix-cache hit).  Returns the last real token's logits."""
        P = self.cache.page_size
        plen = len(seq)
        table = self._dev(self.cache.page_table[slot], torch.long)
        logits = None
        for ci in range(start_chunk, -(-plen // P)):
            base = ci * P
            chunk = np.zeros(P, np.int64)
            real = min(P, plen - base)
            chunk[:real] = seq[base:base + real]
            logits = _paged_prefill_chunk(
                self._layers, self._norm_w, self._head_w, self._embed_w,
                self._rope_prefill, self.cache.k_pages, self.cache.v_pages,
                self._dev(chunk, torch.long), table, base,
                int(self.cache.page_table[slot, ci]),
                min(plen - 1 - base, P - 1), eps=self.eps, kvh=self.kvh,
                head_dim=self.head_dim, tied=self._tied)
        return logits

    def _admit(self, rid, prompt_ids, max_new_tokens, eos_token_id):
        """Shared admission: validate, look up the cached prefix and
        reserve the slot with the request's full page budget.  Returns
        (request, cached tokens, shared pages)."""
        enforce(rid not in self.requests, f"duplicate request id {rid!r}")
        enforce(max_new_tokens >= 1, "max_new_tokens must be >= 1")
        req = GenRequest(rid, prompt_ids, max_new_tokens, eos_token_id)
        plen = len(req.prompt)
        enforce(plen >= 1, "empty prompt")
        total = plen + max_new_tokens
        limit = min(self.max_len, self.config.max_position_embeddings)
        enforce(total <= limit,
                f"prompt ({plen}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds the engine/model limit {limit}")
        P = self.cache.page_size
        cached, shared_pages = 0, []
        if self.enable_prefix_caching:
            # cap at the last page boundary strictly below plen so the
            # chunk holding the last prompt token always runs (its
            # logits seed decoding; shared pages stay immutable)
            cacheable = ((plen - 1) // P) * P
            cached, shared_pages = self.cache.lookup_prefix(
                req.prompt[:cacheable])
        req.slot = self.cache.allocate(total, shared_pages=shared_pages)
        st = self.prefix_stats
        st["hit_tokens"] += cached
        st["miss_tokens"] += plen - cached
        st["shared_pages"] += len(shared_pages)
        st["hit_requests" if cached else "miss_requests"] += 1
        return req, cached

    def _finish_prefill(self, req, first: int):
        """Bookkeeping once a prompt is fully prefilled: set the length,
        publish its full pages, record the first token, and join the
        decode batch (or retire at once)."""
        P = self.cache.page_size
        plen = len(req.prompt)
        self.cache.set_len(req.slot, plen)
        if self.enable_prefix_caching:
            self.cache.register_prefix(req.slot, req.prompt,
                                       upto=(plen // P) * P)
        req.out.append(first)
        if (req.eos is not None and first == req.eos) or req.max_new <= 1:
            req.done = True
            self.cache.release(req.slot)
        else:
            self._active.append(req)

    # -- admission -------------------------------------------------------------
    def add_request(self, rid, prompt_ids, max_new_tokens: int = 64,
                    eos_token_id: Optional[int] = None):
        """Prefill the prompt into pages now (page-size chunks through
        the flash kernel); the request joins the decode batch at the
        next ``step()``.  The longest cached page-aligned prefix is
        mapped in without device work and only the tail prefills."""
        req, cached = self._admit(rid, prompt_ids, max_new_tokens,
                                  eos_token_id)
        P = self.cache.page_size
        try:
            logits = self._prefill_seq(req.slot, req.prompt, cached // P)
            tok, _ = sample_logits(logits[None],
                                   strategy=self.decode_strategy)
            first = int(tok[0])
        except BaseException:
            # the slot and its page references must not leak
            self.cache.release(req.slot)
            raise
        self.requests[rid] = req
        self._finish_prefill(req, first)
        return rid

    def begin_request(self, rid, prompt_ids, max_new_tokens: int = 64,
                      eos_token_id: Optional[int] = None):
        """Deferred admission: reserve the slot and page budget now and
        prefill the prompt inside later ``step()`` calls, page-sized
        chunks riding the same mixed batch as the ongoing decodes, up to
        ``prefill_token_budget`` tokens a step.  The first token arrives
        in a later ``step()`` return value."""
        req, cached = self._admit(rid, prompt_ids, max_new_tokens,
                                  eos_token_id)
        req.pf_pos = cached
        self.requests[rid] = req
        self._prefilling.append(req)
        return rid

    # -- decode loop -----------------------------------------------------------
    def step(self) -> Dict[object, List[int]]:
        """One serving step: returns {request_id: [new tokens]} and
        retires finished requests.

        One mixed-batch forward packs every active decode slot plus up
        to ``prefill_token_budget`` tokens of pending ``begin_request``
        prefill chunks (chunks never cross a page boundary, so one
        request may contribute several descriptors).  When no prefill is
        pending, a window of up to ``steps_per_sync`` decode steps runs
        host-chained, each step's tokens fed back as the next input."""
        if not self._active and not self._prefilling:
            return {}
        P = self.cache.page_size
        maxp = self.cache.page_table.shape[1]
        t_cap = self.max_seqs + self._pf_budget_static
        batch = list(self._active)
        n = len(batch)

        # prefill plan: (req, pos, chunk_len, first_row, descriptor).
        # The runtime budget is clamped to the static one (T is fixed)
        # and floored when only prefill is pending, so a zero budget
        # cannot livelock has_work().
        budget = max(0, min(int(self.prefill_token_budget),
                            self._pf_budget_static))
        if not batch and budget == 0:
            budget = min(P, self._pf_budget_static)
        plan = []
        finishing = []                        # (req, last_row)
        cursor, desc_i, used = n, n, 0
        for req in self._prefilling:
            plen = len(req.prompt)
            pos = req.pf_pos
            while pos < plen and used < budget:
                cl = min(P - pos % P, plen - pos, budget - used)
                plan.append((req, pos, cl, cursor, desc_i))
                pos += cl
                cursor += cl
                used += cl
                desc_i += 1
            if pos >= plen:
                finishing.append((req, cursor - 1))
            if used >= budget:
                break
        if not batch and not plan:
            return {}

        if plan or n == 0:
            nsteps = 1
        else:
            nsteps = min([self.steps_per_sync] +
                         [r.max_new - len(r.out) for r in batch])
            nsteps = max(nsteps, 1)
            while nsteps & (nsteps - 1):      # power-of-two windows
                nsteps &= nsteps - 1
        slots = np.array([r.slot for r in batch], np.int64)
        for r in batch:
            self.cache.extend(r.slot, nsteps)

        ids = np.zeros(t_cap, np.int32)
        positions = np.zeros(t_cap, np.int32)
        q_start = np.zeros(t_cap, np.int32)
        q_len = np.zeros(t_cap, np.int32)
        kv_len = np.zeros(t_cap, np.int32)
        desc_tables = np.zeros((t_cap, maxp), np.int32)
        # padding rows point at their own (q_len == 0) descriptor, whose
        # kernel output block is zeroed — never garbage
        desc_of_row = np.arange(t_cap, dtype=np.int32)
        off_of_row = np.zeros(t_cap, np.int32)
        if n:
            ids[:n] = [r.out[-1] for r in batch]
            lens = self.cache.seq_lens[slots]
            positions[:n] = lens
            q_start[:n] = np.arange(n)
            q_len[:n] = 1
            kv_len[:n] = lens
            desc_tables[:n] = self.cache.page_table[slots]
        for req, pos, cl, row0, d in plan:
            ids[row0:row0 + cl] = req.prompt[pos:pos + cl]
            positions[row0:row0 + cl] = np.arange(pos, pos + cl)
            q_start[d] = row0
            q_len[d] = cl
            kv_len[d] = pos
            desc_tables[d] = self.cache.page_table[req.slot]
            desc_of_row[row0:row0 + cl] = d
            off_of_row[row0:row0 + cl] = np.arange(cl)

        dq_start, dq_len = self._dev(q_start), self._dev(q_len)
        ddesc_tables = self._dev(desc_tables)
        ddesc_of_row = self._dev(desc_of_row, torch.long)
        doff_of_row = self._dev(off_of_row, torch.long)
        toks_all = []
        for si in range(nsteps):
            logits = _mixed_forward(
                self._layers, self._norm_w, self._head_w, self._embed_w,
                self._rope, self.cache.k_pages, self.cache.v_pages,
                self._dev(ids, torch.long), self._dev(positions, torch.long),
                dq_start, dq_len, self._dev(kv_len), ddesc_tables,
                ddesc_of_row, doff_of_row, eps=self.eps, kvh=self.kvh,
                head_dim=self.head_dim, tied=self._tied)
            nxt, _ = sample_logits(logits, strategy=self.decode_strategy)
            nxt = nxt.cpu().numpy()
            toks_all.append(nxt)
            if n:
                self.cache.advance(slots, 1)
            if si + 1 < nsteps:
                # host-chained window (pure decode): feed each slot's
                # token back as the next input
                ids[:n] = nxt[:n]
                positions[:n] += 1
                kv_len[:n] += 1

        out = {}
        for i, req in enumerate(batch):
            new_toks = []
            for j in range(nsteps):
                if req.done:
                    break
                tok = int(toks_all[j][i])
                req.out.append(tok)
                new_toks.append(tok)
                if (req.eos is not None and tok == req.eos) or \
                        len(req.out) >= req.max_new:
                    req.done = True
                    self.cache.release(req.slot)
                    self._active.remove(req)
            if new_toks:
                out[req.rid] = new_toks
        # prefill bookkeeping after the forward succeeded — a raise
        # above leaves every pf_pos where it was
        for req, pos, cl, row0, d in plan:
            req.pf_pos = pos + cl
        for req, last_row in finishing:
            self._prefilling.remove(req)
            self._finish_prefill(req, int(toks_all[0][last_row]))
            out[req.rid] = [req.out[-1]]
        return out

    def has_work(self) -> bool:
        return bool(self._active or self._prefilling)

    def free_slots(self) -> int:
        """Sequence slots available for admission right now.  A request
        fits iff ``free_slots() >= 1`` and ``cache.free_pages() >=
        ceil((len(prompt) + max_new_tokens) / page_size)``: admission
        reserves the full page budget."""
        return self.cache.free_slot_count()

    def abort(self, rid) -> bool:
        """Cancel a request: release its pages and retire it with
        ``cancelled=True``.  Returns True if it was live, False if it had
        already retired; unknown ids raise."""
        enforce(rid in self.requests,
                f"unknown request id {rid!r} (never admitted to this "
                f"engine)")
        req = self.requests[rid]
        if req.done:
            return False
        req.done = True
        req.cancelled = True
        if req in self._active:
            self._active.remove(req)
        else:
            self._prefilling.remove(req)
        self.cache.release(req.slot)
        return True

    def result(self, rid) -> List[int]:
        """Final token list of a retired request (EOS, budget, or
        ``abort``); raises while it is still generating, and for unknown
        ids.  Results stay readable until ``pop_result``."""
        enforce(rid in self.requests,
                f"unknown request id {rid!r} (never admitted to this "
                f"engine)")
        req = self.requests[rid]
        enforce(req.done,
                f"request {rid!r} is still generating ({len(req.out)} "
                f"tokens so far) — consume step() output to stream, "
                f"or call result() after it retires")
        return list(req.out)

    def pop_result(self, rid) -> List[int]:
        """``result(rid)``, then forget the request."""
        out = self.result(rid)
        del self.requests[rid]
        return out
