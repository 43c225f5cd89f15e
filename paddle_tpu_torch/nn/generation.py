"""Autoregressive decoding: token selection, the static KV cache and
``model.generate`` (counterpart of ``paddle_tpu/nn/generation.py``).

Sampling draws from the threefry stream of ``common/prng.py``, the
reference's ``jax.random`` bit for bit, so a seed gives the reference's
tokens: ``sample_logits`` applies temperature, top-k and top-p to f32
logits in the reference's order and draws one categorical, either over
the whole ``[B, V]`` block with one key (``generate``) or row by row on
``fold_row(key, row)`` keys (the serving engine).

``generate`` runs the reference's decode loop eagerly: a prefill over
the prompt (causal flash attention, then the prompt's K/V written into
fixed-size ``StaticCache`` buffers), then one forward a token through
``cached_attention_raw``.  Greedy search and sampling keep one row a
prompt; beam search keeps ``num_beams`` rows a prompt and reorders every
cache along the batch after each step, with the reference's pool of
finished hypotheses.  The reference compiles one program per call
signature and keeps the last 8 in an LRU; the port runs eagerly, so it
has nothing to compile or cache.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..common import prng
from ..common.errors import enforce

__all__ = ["StaticCache", "GenerationMixin", "sample_logits",
           "filtered_probs", "cached_attention_raw", "write_cache_raw"]


class StaticCache(NamedTuple):
    """Fixed-size KV buffers of one attention layer: k/v ``[B, T, HK,
    D]``."""
    k: torch.Tensor
    v: torch.Tensor


# ---------------------------------------------------------------------------
# attention against a static buffer
# ---------------------------------------------------------------------------

def write_cache_raw(k_new, v_new, k_buf, v_buf, pos: int):
    """Write ``k_new``/``v_new`` ``[B, S, HK, D]`` into the buffers at
    positions ``pos .. pos + S`` (in place, cast to the buffers' dtype);
    returns the buffers."""
    s = k_new.shape[1]
    k_buf[:, pos:pos + s] = k_new.to(k_buf.dtype)
    v_buf[:, pos:pos + s] = v_new.to(v_buf.dtype)
    return k_buf, v_buf


def cached_attention_raw(q, k_new, v_new, k_buf, v_buf, pos: int):
    """Write the new K/V at ``pos`` and attend q ``[B, S, H, D]`` over
    positions ``[0, pos + S)`` of the buffers, causally (query row r sees
    keys ``<= pos + r``).  The buffers are read in their stored dtype
    and widened exactly; scores, softmax and the value product are f32,
    as the reference's ``preferred_element_type=f32``.  Returns (out
    ``[B, S, H, D]`` in q's dtype, k_buf, v_buf)."""
    b, s, h, d = q.shape
    hk = k_buf.shape[2]
    g = h // hk
    k_buf, v_buf = write_cache_raw(k_new, v_new, k_buf, v_buf, pos)
    t = pos + s                    # later positions are masked: not read
    qg = q.to(k_buf.dtype).float().reshape(b, s, hk, g, d)
    kf, vf = k_buf[:, :t].float(), v_buf[:, :t].float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * (1.0 / math.sqrt(d))
    q_pos = pos + torch.arange(s, device=q.device)
    mask = torch.arange(t, device=q.device)[None, :] <= q_pos[:, None]
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, vf)
    return out.reshape(b, s, h, d).to(q.dtype), k_buf, v_buf


# ---------------------------------------------------------------------------
# logits processing / sampling
# ---------------------------------------------------------------------------

def _top_k_filter(logits, k: int):
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def _top_p_filter(logits, p: float):
    """Keep the smallest prefix of the sorted logits whose mass reaches
    ``p`` (the top one always).  The kept set depends on a cumulative
    sum, so a prefix mass within an ulp of ``p`` may keep one entry more
    or less than the reference's sum, taken in another order."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    keep = torch.cat([torch.ones_like(cum[..., :1], dtype=torch.bool),
                      cum[..., :-1] < p], dim=-1)
    thresh = torch.where(keep, sorted_logits,
                         torch.full_like(sorted_logits, float("inf")))
    thresh = thresh.min(dim=-1, keepdim=True).values
    return logits.masked_fill(logits < thresh, float("-inf"))


def _filtered_logits(logits, top_k, top_p, temperature):
    """f32 logits after temperature, top-k and top-p, in that order."""
    filt = logits.float()
    if temperature != 1.0:
        # a device scalar: CUDA divides by a host scalar as a product
        # with its reciprocal, which rounds differently
        filt = filt / torch.full((), temperature, dtype=torch.float32,
                                 device=filt.device)
    if top_k and top_k > 0:
        filt = _top_k_filter(filt, top_k)
    if top_p < 1.0:
        filt = _top_p_filter(filt, top_p)
    return filt


def filtered_probs(logits, *, strategy: str = "greedy_search",
                   top_k: int = 0, top_p: float = 1.0,
                   temperature: float = 1.0):
    """logits ``[B, V]`` -> the f32 probabilities ``[B, V]`` that
    ``sample_logits`` draws from (the same filters in the same order);
    greedy gives the one-hot of the arg max.  Speculative decoding's
    rejection acceptance reads these as its p and q."""
    if strategy == "greedy_search":
        return torch.nn.functional.one_hot(
            torch.argmax(logits, dim=-1), logits.shape[-1]).float()
    return torch.softmax(_filtered_logits(logits, top_k, top_p,
                                          temperature), dim=-1)


def sample_logits(logits, key=None, *, strategy: str = "greedy_search",
                  top_k: int = 0, top_p: float = 1.0,
                  temperature: float = 1.0, row_ids=None):
    """logits ``[B, V]`` -> (token ``[B]`` int32, logprob ``[B]`` f32).

    Greedy takes the arg max (first index on ties, as ``jnp.argmax``)
    and ignores ``key``.  Sampling draws a categorical over the filtered
    logits: with ``row_ids`` (``[B]`` ints) row i on the key
    ``fold_row(key, row_ids[i])``, so its draw does not depend on the
    other rows of the batch (the engine's contract); without, one draw
    over the whole block with ``key`` (``generate``'s)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    if strategy == "greedy_search":
        tok = torch.argmax(logits, dim=-1)
    else:
        enforce(strategy == "sampling",
                f"unsupported decode strategy {strategy!r}")
        filt = _filtered_logits(logits, top_k, top_p, temperature)
        row_keys = None if row_ids is None else \
            prng.fold_in_rows(key, row_ids)
        tok = prng.categorical(key, filt, row_keys=row_keys)
    return tok.to(torch.int32), logp.gather(-1, tok[:, None].long())[:, 0]


def _top_k(x, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest values and
    their indices, equal values in index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# ---------------------------------------------------------------------------
# GenerationMixin
# ---------------------------------------------------------------------------

class GenerationMixin:
    """``model.generate`` for causal LMs with the static-cache protocol:
    ``forward(input_ids, caches=[StaticCache, ...], pos=int,
    prefill=bool)`` returning (logits, caches), and
    ``gen_static_caches(batch, total_len)``."""

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 20,
                 max_length: Optional[int] = None,
                 decode_strategy: str = "greedy_search",
                 top_k: int = 0, top_p: float = 1.0,
                 temperature: float = 1.0,
                 eos_token_id: Optional[int] = None,
                 pad_token_id: int = 0, seed: int = 0,
                 num_beams: int = 1, length_penalty: float = 0.0):
        """Returns (generated ids ``[B, max_new_tokens]`` int32, scores
        ``[B]`` f32), the prompt excluded.  Scores are the cumulative
        log-probability of the generated tokens (beam search:
        ``sum / length ** length_penalty`` of the best hypothesis).
        Finished rows (``eos_token_id``) are padded with
        ``pad_token_id``.  ``max_length`` counts the prompt."""
        enforce(decode_strategy in ("greedy_search", "sampling",
                                    "beam_search"),
                f"unsupported decode_strategy {decode_strategy!r}")
        if decode_strategy == "beam_search":
            enforce(num_beams >= 2, "beam_search needs num_beams >= 2")
        dev = next(self.parameters()).device
        ids = torch.as_tensor(np.asarray(
            input_ids.cpu() if isinstance(input_ids, torch.Tensor)
            else input_ids).astype(np.int64), device=dev)
        b, s = ids.shape
        if max_length is not None:
            max_new_tokens = max_length - s
        enforce(max_new_tokens > 0, "nothing to generate")
        key = prng.prng_key(seed)
        if decode_strategy == "beam_search":
            return self._beam_search(ids, max_new_tokens, eos_token_id,
                                     pad_token_id, num_beams,
                                     length_penalty)
        return self._sample_loop(ids, max_new_tokens, decode_strategy,
                                 top_k, top_p, temperature, eos_token_id,
                                 pad_token_id, key)

    def _gen_forward(self, token_ids, caches, pos: int, prefill=False):
        """One model call: (last-position logits ``[B, V]``, caches)."""
        logits, caches = self(token_ids, caches=caches, pos=pos,
                              prefill=prefill)
        return logits[:, -1], caches

    def _sample_loop(self, ids, max_new, strategy, top_k, top_p,
                     temperature, eos_token_id, pad_token_id, key):
        """Greedy search and sampling: one row a prompt, one key split
        a step (the reference's scan body).  The loop stops once every
        row is finished; the rest is padding either way."""
        b, s = ids.shape
        kw = dict(strategy=strategy, top_k=top_k, top_p=top_p,
                  temperature=temperature)
        caches = self.gen_static_caches(b, s + max_new)
        logits, caches = self._gen_forward(ids, caches, 0, prefill=True)
        key, sub = prng.split(key)
        tok, scores = sample_logits(logits, sub, **kw)
        done = torch.zeros(b, dtype=torch.bool, device=ids.device) \
            if eos_token_id is None else tok == eos_token_id
        out = torch.full((b, max_new), pad_token_id, dtype=torch.int32,
                         device=ids.device)
        out[:, 0] = tok
        for t in range(1, max_new):
            if eos_token_id is not None and bool(done.all()):
                break
            logits, caches = self._gen_forward(tok[:, None].long(), caches,
                                               s + t - 1)
            key, sub = prng.split(key)
            nxt, lp = sample_logits(logits, sub, **kw)
            nxt = torch.where(done, torch.full_like(nxt, pad_token_id), nxt)
            scores = scores + torch.where(done, torch.zeros_like(lp), lp)
            if eos_token_id is not None:
                done = done | (nxt == eos_token_id)
            out[:, t] = nxt
            tok = nxt
        return out, scores

    def _beam_search(self, ids, max_new, eos_token_id, pad_token_id, K,
                     length_penalty):
        """Beam search with the reference's pool of finished hypotheses:
        a beam that emits EOS enters the pool with its score and length
        frozen; live beams never hold EOS; the answer is the best
        length-penalized hypothesis of pool and live beams.  Beams are an
        expanded batch ``[b * K]``; each step gathers every cache along
        the batch in the new beam order."""
        b, s = ids.shape
        dev = ids.device
        neg = -1e30
        caches = self.gen_static_caches(b, s + max_new)
        logits, caches = self._gen_forward(ids, caches, 0, prefill=True)
        logp0 = torch.log_softmax(logits.float(), dim=-1)
        if eos_token_id is not None:
            logp0[:, eos_token_id] = neg
        scores, tok = _top_k(logp0, K)                      # [b, K]
        caches = [type(c)(c.k.repeat_interleave(K, dim=0),
                          c.v.repeat_interleave(K, dim=0)) for c in caches]
        hist = torch.full((b, K, max_new), pad_token_id, dtype=torch.int32,
                          device=dev)
        hist[:, :, 0] = tok
        barange = torch.arange(b, device=dev)[:, None]
        pool_scores = torch.full((b, K), neg, device=dev)
        pool_len = torch.ones((b, K), device=dev)
        pool_hist = torch.full((b, K, max_new), pad_token_id,
                               dtype=torch.int32, device=dev)
        for t in range(1, max_new):
            logits, caches = self._gen_forward(
                tok.reshape(b * K, 1).long(), caches, s + t - 1)
            logp = torch.log_softmax(logits.float(), dim=-1).reshape(b, K, -1)
            v = logp.shape[-1]
            if eos_token_id is not None:
                # every live beam may finish now, its score frozen
                eos_sc = scores + logp[:, :, eos_token_id]
                eos_hist = hist.clone()
                eos_hist[:, :, t] = eos_token_id
                eos_len = torch.full((b, K), float(t + 1), device=dev)
                pool_scores, keep = _top_k(
                    torch.cat([pool_scores, eos_sc], dim=1), K)
                pool_len = torch.cat([pool_len, eos_len], 1)[barange, keep]
                pool_hist = torch.cat([pool_hist, eos_hist], 1)[barange,
                                                                  keep]
                logp[:, :, eos_token_id] = neg
            cand = scores[:, :, None] + logp                  # [b, K, V]
            scores, idx = _top_k(cand.reshape(b, K * v), K)
            beam_idx = idx // v
            tok = (idx % v).to(torch.int32)
            hist = hist[barange, beam_idx]
            hist[:, :, t] = tok
            flat_idx = (barange * K + beam_idx).reshape(b * K)
            caches = [type(c)(c.k[flat_idx], c.v[flat_idx]) for c in caches]

        def penalize(sc, ln):
            return sc if length_penalty == 0.0 else \
                sc / ln ** length_penalty

        live_len = torch.full((b, K), float(max_new), device=dev)
        final_sc = torch.cat([penalize(pool_scores, pool_len),
                              penalize(scores, live_len)], dim=1)
        final_hist = torch.cat([pool_hist, hist], dim=1)
        best = torch.argmax(final_sc, dim=1)
        rows = torch.arange(b, device=dev)
        return final_hist[rows, best], final_sc[rows, best]
