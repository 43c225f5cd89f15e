"""Speculative decoding: the draft's proposals and the acceptance rules
(counterpart of ``paddle_tpu/inference/speculative.py``).

The engine (``LLMEngine(draft_model=...)``) runs a speculative window in
three moves:

1. propose: the draft, over its own ``PagedKVCache``, free-runs ``k``
   tokens for every sequence through the split path's decode forward
   (kernel #7 in every layer), keyed on the ``split_step`` x
   ``fold_row`` grid of plain decoding (``_paged_draft_propose``);
2. verify: the target scores ``[last, d_1 .. d_k]`` of every sequence
   in one ragged forward (kernel #1), ``k + 1`` query rows a sequence;
3. accept (this module).  Greedy: the longest prefix where the draft
   matched the target's arg max, plus the target's next token, which is
   plain greedy decoding token for token.  Sampling: accept ``d_j``
   with probability ``min(1, p_j(d_j) / q_j(d_j))`` and resample the
   first reject from ``normalize(max(p - q, 0))``, which keeps the
   target's filtered distribution for any draft; full acceptance draws
   the bonus token from ``p_k``.

Rejected suffixes roll back with ``PagedKVCache.rollback``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..common import prng
from ..common.errors import enforce
from ..nn.generation import filtered_probs, sample_logits
from .sampling import spec_draw_key, split_step

__all__ = ["greedy_accept", "rejection_accept", "residual_dist",
           "acceptance_uniforms"]


def _paged_draft_propose(forward, tokens, lens, key, draw_base: int = 0, *,
                         n_live: int, n_steps: int,
                         strategy: str = "greedy_search", top_k: int = 0,
                         top_p: float = 1.0, temperature: float = 1.0,
                         collect_probs: bool = False):
    """``n_steps`` free-running draft tokens for every row: each step
    runs ``forward(tokens, lens)`` (the draft's decode forward over the
    padded batch, tokens at lengths ``lens``, host arrays; returns logits
    ``[B, V]``), splits ``key`` once and samples row i on
    ``fold_row(sub, draw_base + i)``; the token feeds the next step.
    Only the first ``n_live`` rows are drawn (the others are padding).

    Returns tokens ``[n_steps, B]`` (host int64, zero past ``n_live``)
    and, with ``collect_probs``, the filtered draft distributions ``q``
    ``[n_steps, n_live, V]`` f64 on the host (the rejection acceptance's
    q); else None."""
    tokens = np.asarray(tokens, np.int64).copy()
    lens = np.asarray(lens, np.int32).copy()
    toks = np.zeros((n_steps, tokens.shape[0]), np.int64)
    probs = []
    kw = dict(strategy=strategy, top_k=top_k, top_p=top_p,
              temperature=temperature)
    rows = draw_base + np.arange(n_live)
    for j in range(n_steps):
        logits = forward(tokens, lens)[:n_live]
        key, sub = split_step(key)
        tok, _ = sample_logits(logits, sub, row_ids=rows, **kw)
        if collect_probs:
            probs.append(filtered_probs(logits, **kw).double().cpu())
        toks[j, :n_live] = tok.cpu().numpy()
        tokens = toks[j].copy()
        lens = lens + 1
    if not collect_probs:
        return toks, None
    return toks, torch.stack(probs).numpy()


def greedy_accept(draft_toks, target_toks):
    """One row's greedy acceptance: ``draft_toks`` [k] are the draft's
    proposals, ``target_toks`` [k+1] the verify rows' arg maxes.  The
    delivered tokens are ``target_toks[:a + 1]``, with ``a`` the longest
    prefix where they equal the draft's.  Returns ``(tokens,
    n_accepted)``."""
    draft_toks = np.asarray(draft_toks)
    target_toks = np.asarray(target_toks)
    k = int(draft_toks.shape[0])
    enforce(target_toks.shape[0] == k + 1,
            "greedy_accept wants k+1 verify rows for k draft tokens")
    a = 0
    while a < k and int(target_toks[a]) == int(draft_toks[a]):
        a += 1
    return [int(t) for t in target_toks[:a + 1]], a


def residual_dist(p, q):
    """The resample distribution ``normalize(max(p - q, 0))`` [V] f64;
    ``p`` itself (normalized) where the residual mass vanishes."""
    r = np.maximum(np.asarray(p, np.float64) - np.asarray(q, np.float64),
                   0.0)
    s = float(r.sum())
    if s <= 1e-12:
        p = np.asarray(p, np.float64)
        return p / max(float(p.sum()), 1e-30)
    return r / s


def acceptance_uniforms(accept_root, steps: int, row: int):
    """The row's acceptance uniforms ``u_0 .. u_{steps-1}``: one draw a
    step on ``spec_draw_key(accept_root, j, row)``, host floats."""
    return [float(prng.uniform(spec_draw_key(accept_root, j, row)))
            for j in range(steps)]


def _draw(key, dist):
    """One categorical draw from the probabilities ``dist`` [V] (its
    log in f32, zeros at -inf), as the reference's."""
    logits = torch.log(torch.as_tensor(np.asarray(dist), dtype=torch.float32))
    return int(prng.categorical(key, logits[None])[0])


def rejection_accept(draft_toks, q_probs, p_probs, accept_root,
                     resample_root, row):
    """One row's rejection acceptance.  ``draft_toks`` [k]: the draft's
    proposals; ``q_probs`` [k, V]: the filtered draft distribution each
    was drawn from; ``p_probs`` [k+1, V]: the target's filtered
    distribution at the verify rows (row k: the bonus); the window's
    accept and resample roots, and the request's draw id ``row``.
    Returns ``(tokens, n_accepted)`` as ``greedy_accept``."""
    draft_toks = np.asarray(draft_toks)
    k = int(draft_toks.shape[0])
    q_probs = np.asarray(q_probs, np.float64)
    p_probs = np.asarray(p_probs, np.float64)
    enforce(p_probs.shape[0] == k + 1,
            "rejection_accept wants k+1 verify rows for k draft tokens")
    us = acceptance_uniforms(accept_root, k, row)
    out = []
    for j in range(k):
        d = int(draft_toks[j])
        ratio = p_probs[j, d] / max(q_probs[j, d], 1e-30)
        if us[j] < min(1.0, ratio):
            out.append(d)
            continue
        tok = _draw(spec_draw_key(resample_root, j, row),
                    residual_dist(p_probs[j], q_probs[j]))
        return out + [tok], j
    # full acceptance: the bonus row is "reject at k with q := 0", whose
    # residual is p_k itself, on step k of the same resample chain
    return out + [_draw(spec_draw_key(resample_root, k, row),
                        p_probs[k])], k
