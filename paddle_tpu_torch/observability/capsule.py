"""Request capsules: deterministic capture, bit-exact replay, and the
divergence audit (counterpart of ``paddle_tpu/observability/capsule.py``).

* ``CapsuleStore`` — a bounded ring (oldest evicted) of per-request
  capsules: prompt token ids, sampling parameters, the engine's config
  fingerprint (``LLMEngine.config_fingerprint()``: pools, page geometry,
  steps_per_sync, unified/split, the model's config hash), the
  admission key anchor and the key of every decode window, prefix-hit
  extents, the delivered token stream, events and the lifecycle
  timeline.  Triggered captures (slow TTFT, deadline miss, error,
  sentinel trip) are ``persist``-ed: spilled to a JSONL file when
  configured.  The store is the reference's line for line, so a capsule
  is plain JSON either package reads.

* ``replay_capsule(capsule, engine)`` — re-runs the request through the
  port engine's own entry points (``_prefill_seq`` page chunks, then
  teacher-forced decode windows of the split path's forward, kernel #7)
  into a scratch slot, and reports the first divergent step, expected
  and got tokens, and the logprob delta there.  Keys are threefry words
  equal to ``jax.random``'s (``common/prng.py``), so a capsule captured
  by the reference engine replays here key for key.

* ``divergence_audit(engine)`` — replays N deterministically sampled
  complete capsules and records the verdict on the store.

Disabled is free: capture sites read one module global and get the
shared ``NULL_CAPSULE_STORE``, whose methods are no-ops.  Capture only
observes a step: it never touches the engine key or a device tensor.
The engine is imported inside ``replay_capsule`` (the engine imports
this module).
"""
from __future__ import annotations

import copy
import hashlib
import itertools
import json
import random
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional

from ..common.errors import enforce

__all__ = [
    "CapsuleStore", "NULL_CAPSULE_STORE", "enable_capsule_capture",
    "disable_capsule_capture", "get_capsule_store",
    "model_fingerprint", "replay_capsule", "divergence_audit",
]

# fingerprint keys that can change the TOKEN STREAM itself — a replay
# across engines differing here is cross-CONFIG, reported as
# ``fingerprint_mismatch`` (the audit still runs: divergence is then
# expected information, not a bug).  Engine id / seed / pool sizes are
# deliberately absent: replicas differ there by design and must still
# replay bit-exact.
_TOKEN_AFFECTING = (
    "model_hash", "kv_dtype", "weight_dtype", "page_size",
    "decode_strategy", "top_k", "top_p", "temperature",
    # MoE router geometry (num_experts/k/norm_topk/capacity/shared):
    # a tampered router config routes differently and must refuse
    # replay.  The dispatch MODE (grouped vs dense) is deliberately
    # inside neither — the two are bit-identical, like tp.
    "moe",
    # speculative geometry (draft_hash/k/mode): a different draft
    # proposes different tokens, which moves the SAMPLED stream (the
    # acceptance draws walk different proposals) even though the
    # greedy stream is draft-invariant by construction — replay
    # across changed draft geometry reports, it does not silently
    # pass.
    "spec",
)


def model_fingerprint(model) -> str:
    """Cheap content hash of a model's architecture config — enough to
    tell "replayed on a different model" from "same model, divergent
    math".  Hashes the config dict (sorted) rather than the weights:
    weight hashing would device-sync megabytes per engine build, and a
    config collision with different weights still shows up as a token
    divergence, which is what the replay report is for."""
    try:
        items = sorted(
            (k, repr(v)) for k, v in vars(model.config).items())
    except TypeError:
        items = [("config", repr(model.config))]
    h = hashlib.sha256(repr(items).encode()).hexdigest()[:16]
    return h


class _NullCapsuleStore:
    """Shared no-op singleton returned while capture is disabled: the
    engine/scheduler capture sites pay one global read + one attribute
    check and nothing else.  ``__slots__ = ()`` keeps it stateless so
    the identity assert (``get_capsule_store() is NULL_CAPSULE_STORE``)
    is also a no-leak assert."""
    __slots__ = ()
    enabled = False
    slow_ttft: Optional[float] = None

    def begin(self, rid, **kw):
        pass

    def on_window(self, out, key_words, n_steps, steps_done, path,
                  rows=None, accepted=None):
        pass

    def annotate(self, rid, timeline=None, trace_id=None,
                 complete=False):
        pass

    def event(self, rid, name):
        pass

    def persist(self, rid, reason):
        return None

    def capsule_id(self, rid):
        return None

    def get(self, rid):
        return None

    def export(self, rid):
        return None

    def adopt(self, capsule):
        return None

    def sample_complete(self, n, seed=0):
        return []

    def record_replay(self, report):
        pass

    def record_audit(self, summary):
        pass

    def snapshot(self):
        return {"enabled": False}

    def capsulez(self):
        return {"enabled": False}


NULL_CAPSULE_STORE = _NullCapsuleStore()


class CapsuleStore:
    """Bounded ring of request capsules + JSONL spill for persisted
    (triggered) captures.  Thread-safe: capture sites run on the
    scheduler's stepping thread, endpoints and audits on HTTP handler
    threads."""
    enabled = True

    def __init__(self, capacity: int = 256,
                 spill_path: Optional[str] = None,
                 slow_ttft: Optional[float] = None):
        enforce(capacity >= 1, "capsule capacity must be >= 1")
        self._lock = threading.RLock()
        self._ring: "OrderedDict[object, dict]" = OrderedDict()
        self._seq = itertools.count(1)
        self.capacity = int(capacity)
        self.spill_path = spill_path
        # store-level slow-TTFT threshold (seconds): schedulers /
        # frontends without their own knob trigger-capture past it
        self.slow_ttft = slow_ttft
        self._audits: deque = deque(maxlen=8)
        self.counters = {"captured_total": 0, "persisted_total": 0,
                         "evicted_total": 0, "adopted_total": 0,
                         "replays_total": 0, "divergent_replays_total": 0}

    # -- capture ---------------------------------------------------------------
    def begin(self, rid, *, prompt, max_new, eos, fingerprint,
              key_anchor, prefix, tokens):
        """Open a capsule at engine admission.  ``key_anchor`` is the
        admission subkey's uint32 words (``add_request`` samples the
        first token with it) or None on the deferred ``begin_request``
        path, where the first token rides a later window's key chain
        like every other token."""
        cap = {
            "cap_id": None, "rid": rid,
            "prompt": [int(t) for t in prompt],
            "max_new": int(max_new),
            "eos": None if eos is None else int(eos),
            "fingerprint": dict(fingerprint),
            "key_anchor": key_anchor,
            "prefix": dict(prefix or {}),
            "windows": [], "tokens": [int(t) for t in tokens],
            "timeline": [], "trace_id": None,
            "events": [], "persist_reasons": [],
            "complete": False, "t_created": time.time(),
        }
        with self._lock:
            cap["cap_id"] = f"c{next(self._seq)}"
            self._ring[rid] = cap
            self._ring.move_to_end(rid)
            self.counters["captured_total"] += 1
            while len(self._ring) > self.capacity:
                self._ring.popitem(last=False)
                self.counters["evicted_total"] += 1

    def on_window(self, out: Dict[object, List[int]], key_words,
                  n_steps: int, steps_done: int, path: str,
                  rows: Optional[Dict[object, int]] = None,
                  accepted: Optional[Dict[object, int]] = None):
        """Record one decode window for every captured rid it
        delivered tokens to: the window's forked key (the anchor of
        its in-window ``split_step`` chain), the STATIC dispatch size
        ``n_steps``, the early-exit ``steps_done``, how many tokens
        THIS rid took from it, which compiled path ran, and — via
        ``rows`` — the BATCH ROW the rid occupied.  The row is what
        lets stochastic replay re-fold the request's exact per-row
        draw id whatever slot it decoded in (the carried row>0 gap);
        greedy replay never reads it.  The delivered tokens extend the
        capsule's stream — the capsule always mirrors ``req.out``.

        Speculative windows (path ``"spec_window"``, ``n_steps = k_run
        + 1``) additionally record the rid's ACCEPTED draft-token
        count via ``accepted`` — the replay re-runs the whole
        propose/verify/accept window and audits both the delivered
        tokens and the acceptance length."""
        with self._lock:
            for rid, toks in out.items():
                cap = self._ring.get(rid)
                if cap is None:
                    continue
                w = {
                    "key": key_words, "n_steps": int(n_steps),
                    "steps_done": int(steps_done),
                    "n_toks": len(toks), "path": path,
                    "row": int(rows[rid]) if rows and rid in rows
                    else 0}
                if accepted is not None and rid in accepted:
                    w["accepted"] = int(accepted[rid])
                cap["windows"].append(w)
                cap["tokens"].extend(int(t) for t in toks)

    def annotate(self, rid, timeline=None, trace_id=None,
                 complete=False):
        """Sync scheduler-side context into the capsule: the lifecycle
        timeline (scheduler's is authoritative — synced at admission,
        migration, and retirement rather than mirrored per event), the
        trace_id cross-link, and completion."""
        with self._lock:
            cap = self._ring.get(rid)
            if cap is None:
                return
            if timeline is not None:
                cap["timeline"] = [[str(ev), float(t)]
                                   for ev, t in timeline]
            if trace_id is not None:
                cap["trace_id"] = trace_id
            if complete:
                cap["complete"] = True

    def event(self, rid, name: str):
        """Engine/scheduler-side point event (suspend, resume path,
        migration hops) appended to the capsule's own event list."""
        with self._lock:
            cap = self._ring.get(rid)
            if cap is not None:
                cap["events"].append([str(name), time.time()])

    # -- triggered persistence -------------------------------------------------
    def persist(self, rid, reason: str) -> Optional[str]:
        """Triggered capture: pin the capsule with a reason and spill
        it to the JSONL file (once — later triggers on the same
        capsule only append their reason).  Returns the capsule id, or
        None when nothing was captured for ``rid`` (capture enabled
        after admission, evicted, or never admitted)."""
        with self._lock:
            cap = self._ring.get(rid)
            if cap is None:
                return None
            first = not cap["persist_reasons"]
            if reason not in cap["persist_reasons"]:
                cap["persist_reasons"].append(str(reason))
            if first:
                self.counters["persisted_total"] += 1
                if self.spill_path:
                    try:
                        with open(self.spill_path, "a") as f:
                            f.write(json.dumps(cap, default=str))
                            f.write("\n")
                    except OSError:
                        pass  # spill is best-effort; the ring copy
                        # is the source of truth
            return cap["cap_id"]

    # -- access ----------------------------------------------------------------
    def _lookup(self, rid):
        """Ring lookup tolerant of rid representation: HTTP query
        params and flight-recorder events carry rids as strings while
        in-process callers may use the original (possibly int) key."""
        cap = self._ring.get(rid)
        if cap is None and isinstance(rid, str):
            for k, c in self._ring.items():
                if str(k) == rid:
                    return c
        return cap

    def capsule_id(self, rid) -> Optional[str]:
        with self._lock:
            cap = self._lookup(rid)
            return None if cap is None else cap["cap_id"]

    def get(self, rid) -> Optional[dict]:
        with self._lock:
            cap = self._lookup(rid)
            return None if cap is None else copy.deepcopy(cap)

    def export(self, rid) -> Optional[dict]:
        """Remove and return the capsule for a migrating request — it
        travels INSIDE the migration package so a drained request's
        capsule stays whole across replicas (it is plain JSON; the
        transport ships it untouched)."""
        with self._lock:
            cap = self._ring.pop(rid, None)
            if cap is not None:
                cap["events"].append(["exported", time.time()])
            return cap

    def adopt(self, capsule: Optional[dict]):
        """Adopt a migrated capsule on the destination store.  The
        source's window records and key anchor come with it — replay
        on the destination replays the WHOLE history, pre- and
        post-migration tokens alike."""
        if not isinstance(capsule, dict) or "rid" not in capsule:
            return None
        rid = capsule["rid"]
        with self._lock:
            capsule.setdefault("events", []).append(
                ["adopted", time.time()])
            self._ring[rid] = capsule
            self._ring.move_to_end(rid)
            self.counters["adopted_total"] += 1
            while len(self._ring) > self.capacity:
                self._ring.popitem(last=False)
                self.counters["evicted_total"] += 1
            return rid

    def sample_complete(self, n: int, seed: int = 0) -> List[dict]:
        """Deterministic sample of COMPLETE capsules (audit input):
        same seed + same store contents → same sample, so a scheduled
        audit is reproducible."""
        with self._lock:
            done = [copy.deepcopy(c) for c in self._ring.values()
                    if c["complete"]]
        if len(done) <= n:
            return done
        return random.Random(seed).sample(done, n)

    # -- accounting ------------------------------------------------------------
    def record_replay(self, report: dict):
        with self._lock:
            self.counters["replays_total"] += 1
            if report.get("first_divergence") is not None:
                self.counters["divergent_replays_total"] += 1

    def record_audit(self, summary: dict):
        with self._lock:
            self._audits.append(copy.deepcopy(summary))

    # -- exposition ------------------------------------------------------------
    def _brief(self, cap: dict) -> dict:
        return {"cap_id": cap["cap_id"], "rid": str(cap["rid"]),
                "n_tokens": len(cap["tokens"]),
                "n_windows": len(cap["windows"]),
                "complete": cap["complete"],
                "persist_reasons": list(cap["persist_reasons"]),
                "trace_id": cap["trace_id"]}

    def snapshot(self) -> dict:
        """Summary block that rides ``metrics_snapshot()`` /
        ``/statusz`` and federates through ``fleet_snapshot()``."""
        with self._lock:
            caps = list(self._ring.values())
            return {"enabled": True, "live": len(caps),
                    "capacity": self.capacity,
                    "slow_ttft": self.slow_ttft,
                    "spill_path": self.spill_path,
                    **dict(self.counters),
                    "audits": [copy.deepcopy(a) for a in self._audits],
                    "recent": [self._brief(c) for c in caps[-10:]]}

    def capsulez(self) -> dict:
        """Full listing for ``GET /capsulez``."""
        snap = self.snapshot()
        with self._lock:
            snap["capsules"] = [self._brief(c)
                                for c in self._ring.values()]
        return snap


# -- module-global plumbing (one read on the hot path) -------------------------
_STORE: Optional[CapsuleStore] = None


def enable_capsule_capture(capacity: int = 256,
                           spill_path: Optional[str] = None,
                           slow_ttft: Optional[float] = None) -> CapsuleStore:
    """Install the process-global CapsuleStore and return it.  Every
    engine admission and decode window from here on is captured; the
    scheduler's triggered-capture hooks persist on slow TTFT past
    ``slow_ttft``, deadline miss, error, and sentinel trip."""
    global _STORE
    _STORE = CapsuleStore(capacity=capacity, spill_path=spill_path,
                          slow_ttft=slow_ttft)
    return _STORE


def disable_capsule_capture():
    """Drop the global store — capture sites fall back to the shared
    NULL singleton (one global read, no-op methods)."""
    global _STORE
    _STORE = None


def get_capsule_store():
    """The process-global store, or ``NULL_CAPSULE_STORE`` when
    capture is off — callers branch on ``.enabled`` and never
    None-check."""
    return NULL_CAPSULE_STORE if _STORE is None else _STORE


# -- replay --------------------------------------------------------------------
def _new_report(capsule: dict, engine) -> dict:
    return {"cap_id": capsule.get("cap_id"),
            "rid": str(capsule.get("rid")),
            "engine": engine.engine_id,
            "n_tokens": len(capsule.get("tokens") or []),
            "steps_compared": 0, "first_divergence": None,
            "expected": None, "got": None,
            "logprob_expected": None, "logprob_got": None,
            "logprob_delta": None,
            "fingerprint_mismatch": [], "notes": []}


def _token_logprobs(logits, *tokens):
    """Log-probabilities of ``tokens`` under one logits row, in f64 on
    the host (replay is a debug path)."""
    import numpy as np

    if hasattr(logits, "detach"):
        logits = logits.detach().double().cpu().numpy()
    row = np.asarray(logits, np.float64).ravel()
    row = row - row.max()
    logz = float(np.log(np.exp(row).sum()))
    return [float(row[t] - logz) for t in tokens]


def _divergence(report, step, want, got, logits=None):
    report["first_divergence"] = int(step)
    report["expected"] = int(want)
    report["got"] = int(got)
    if logits is not None:
        lp_want, lp_got = _token_logprobs(logits, want, got)
        report["logprob_expected"] = lp_want
        report["logprob_got"] = lp_got
        report["logprob_delta"] = lp_got - lp_want


def _draw(logits, key, strategy, fp, engine, row: int) -> int:
    """The token of one logits row [V] drawn as batch row ``row`` on
    ``key`` (greedy: the arg max), the engine's ``_sample`` rule."""
    import numpy as np

    from ..inference.sampling import sample_logits
    tok, _ = sample_logits(
        logits[None], key, strategy=strategy,
        top_k=fp.get("top_k", engine.top_k),
        top_p=fp.get("top_p", engine.top_p),
        temperature=fp.get("temperature", engine.temperature),
        row_ids=np.array([row], np.int64))
    return int(tok.reshape(-1)[0])


def _decode_window(engine, slot, feed, n_fwd, key, strategy, fp, row):
    """``n_fwd`` host-chained forwards of the split path (kernel #7 in
    every layer) for ``slot`` alone in the padded batch, from token
    ``feed``: each step splits the window key once (``split_step``) and
    draws the slot's token as batch row ``row``, which feeds the next
    step.  The MoE counts of these forwards are dropped (a replay is not
    traffic).  Returns the tokens."""
    import numpy as np
    import torch

    from ..inference import engine as _eng
    from ..inference.sampling import split_step

    lens, tables = engine._split_batch([slot])
    dtables = engine._dev(tables)
    live = engine._dev(lens > 0, torch.bool)
    got = []
    for _ in range(n_fwd):
        tokens = np.zeros(engine.max_seqs, np.int64)
        tokens[0] = feed
        out = _eng._decode_forward(
            engine._layers, engine._norm_w, engine._head_w,
            engine._embed_w, engine._rope, engine.cache.k_pages,
            engine.cache.v_pages, engine._dev(tokens, torch.long),
            dtables, engine._dev(lens), live=live, **engine._fwd_kw())
        logits = out[0] if isinstance(out, tuple) else out
        key, sub = split_step(key)
        feed = _draw(logits[0], sub, strategy, fp, engine, row)
        got.append(feed)
        lens = lens + 1
    return got


def replay_capsule(capsule: dict, engine, *, logprobs: bool = True,
                   store=None) -> dict:
    """Re-run a captured request through the port's ``engine`` and diff
    the token stream step by step.

    The prompt runs through ``_prefill_seq`` (all chunks: replay must
    not depend on what the prefix index holds) into a scratch slot; the
    first token draws on the capsule's admission key anchor (row 0), or,
    for a ``begin_request`` capsule, comes from the prefill's logits
    (greedy).  Greedy decode replays in the power-of-two windows of
    ``steps_per_sync`` (the key is not read); sampling walks the
    recorded windows, each on its recorded key and batch row, so the
    ``split_step`` chain and the per-row draws replay key for key.
    Sampled speculative windows re-run ``_spec_window`` with one scratch
    row.  Teacher forcing: every window starts from the last recorded
    token, so the report pins the first divergence.  The engine's own
    key is never touched and the scratch slots are released on every
    exit.  On a tensor-parallel engine every rank of its mesh replays
    the same capsule (the forwards gather), and a capsule replays across
    tp: tp is in the fingerprint but not token-affecting.

    Report: ``first_divergence`` (generated-token index, None: bit-exact),
    expected and got tokens, the logprob delta at the divergence, and
    any token-affecting ``fingerprint_mismatch`` between the capture and
    this engine."""
    from ..inference.sampling import key_from_fingerprint
    from ..common import prng

    st = store if store is not None else get_capsule_store()
    report = _new_report(capsule, engine)
    fp = capsule.get("fingerprint") or {}
    mine = getattr(engine, "config_fingerprint", lambda: {})()
    report["fingerprint_mismatch"] = [
        k for k in _TOKEN_AFFECTING
        if k in fp and k in mine and fp[k] != mine[k]]
    exp = [int(t) for t in capsule.get("tokens") or []]
    if not exp:
        report["notes"].append("no_tokens_recorded")
        st.record_replay(report)
        return report
    prompt = [int(t) for t in capsule["prompt"]]
    strategy = fp.get("decode_strategy", engine.decode_strategy)
    if strategy != "greedy_search" and any(
            "row" not in w for w in capsule.get("windows") or []):
        report["notes"].append("sampling_replay_row0_only")

    overshoot = max([w["n_steps"] for w in capsule.get("windows") or []]
                    + [int(engine.steps_per_sync)])
    slot = engine.cache.allocate(len(prompt) + len(exp) + overshoot)
    dslot = None
    try:
        logits = engine._prefill_seq(slot, prompt, 0)
        engine.cache.set_len(slot, len(prompt))
        anchored = capsule.get("key_anchor") is not None
        i = 0
        if anchored:
            first = _draw(logits, key_from_fingerprint(
                capsule["key_anchor"]), strategy, fp, engine, 0)
            report["steps_compared"] = 1
            if first != exp[0]:
                _divergence(report, 0, exp[0], first,
                            logits if logprobs else None)
                st.record_replay(report)
                return report
            i = 1
        if strategy == "greedy_search":
            # greedy windows re-bucket to steps_per_sync's powers of
            # two (a speculative greedy stream is the plain stream)
            def plan():
                j = i
                while j < len(exp):
                    n = min(engine.steps_per_sync, len(exp) - j)
                    while n & (n - 1):
                        n &= n - 1
                    yield n, n, prng.prng_key(0), 0, None
                    j += n
        else:
            def plan():
                for w in capsule.get("windows") or []:
                    yield w["n_steps"], w["n_toks"], \
                        key_from_fingerprint(w["key"]), \
                        int(w.get("row", 0)), w
        for n_steps, take, key, draw_row, w in plan():
            if i >= len(exp) or take == 0:
                continue
            take = min(take, len(exp) - i)
            if w is not None and w.get("path") == "spec_window":
                if getattr(engine, "_spec", None) is None:
                    report["notes"].append(
                        "spec_windows_require_draft_engine")
                    break
                k_run = n_steps - 1
                if k_run > engine.spec_k:
                    report["notes"].append(
                        f"spec_k_too_small_for_capsule:"
                        f"{k_run}>{engine.spec_k}")
                    break
                if dslot is None:
                    dslot = engine._spec_cache.allocate(
                        len(prompt) + len(exp) + overshoot)
                    engine._spec_prefill(dslot, prompt)
                cur = len(prompt) + i - 1
                (toks, a), = engine._spec_window(
                    [{"slot": slot, "dslot": dslot,
                      "last": exp[i - 1], "cur": cur,
                      "seq": prompt + exp, "row": draw_row}],
                    key, k_run)
                if "accepted" in w and int(a) != int(w["accepted"]):
                    report["notes"].append(
                        f"accepted_len_mismatch@{i}:"
                        f"want={int(w['accepted'])},got={int(a)}")
                for j in range(take):
                    report["steps_compared"] += 1
                    got_j = int(toks[j]) if j < len(toks) else -1
                    if got_j != exp[i + j]:
                        _divergence(report, i + j, exp[i + j], got_j)
                        st.record_replay(report)
                        return report
                extra = len(toks) - take
                if extra > 0:
                    engine.cache.rollback(slot, extra)
                over = int(engine._spec_cache.seq_lens[dslot]) - \
                    (cur + take)
                if over > 0:
                    engine._spec_cache.rollback(dslot, over)
                i += take
                continue
            if i == 0:
                # a begin_request capsule's first token came out of a
                # mixed step's prefill row: greedy re-derives it from
                # the prefill logits; a sampled draw at that row is
                # skipped and teacher-forced below
                if strategy == "greedy_search":
                    first = int(logits.argmax())
                    report["steps_compared"] = 1
                    if first != exp[0]:
                        _divergence(report, 0, exp[0], first,
                                    logits if logprobs else None)
                        st.record_replay(report)
                        return report
                else:
                    report["notes"].append(
                        "unanchored_sampling_first_token_skipped")
                i = 1
                take -= 1
                if take <= 0:
                    continue
            engine.cache.extend(slot, n_steps)
            got = _decode_window(engine, slot, exp[i - 1], take, key,
                                 strategy, fp, draw_row)
            for j in range(take):
                report["steps_compared"] += 1
                if got[j] != exp[i + j]:
                    ctx_logits = None
                    if logprobs:
                        ctx_logits = _context_logits(
                            engine, prompt + exp[:i + j])
                    _divergence(report, i + j, exp[i + j], got[j],
                                ctx_logits)
                    st.record_replay(report)
                    return report
            engine.cache.advance([slot], take)
            i += take
        if i < len(exp):
            report["notes"].append(
                f"window_records_cover_{i}_of_{len(exp)}_tokens")
        st.record_replay(report)
        return report
    finally:
        engine.cache.release(slot)
        if dslot is not None:
            engine._spec_cache.release(dslot)


def _context_logits(engine, context):
    """Last-token logits over ``prompt + verified tokens`` — one extra
    chunked prefill in a scratch slot, used only to attach logprob
    deltas to an already-found divergence."""
    slot = engine.cache.allocate(len(context) + 1)
    try:
        return engine._prefill_seq(slot, context, 0)
    finally:
        engine.cache.release(slot)


# -- audit ---------------------------------------------------------------------
def divergence_audit(engine, store=None, n: int = 3,
                     seed: int = 0) -> dict:
    """Continuous correctness canary: replay ``n`` deterministically
    sampled COMPLETE capsules on ``engine`` (typically ANOTHER replica
    than the one that captured them — cross-replica bit-exactness is
    the whole point) and record the verdict on the store, where it
    rides ``metrics_snapshot()`` and federates into
    ``fleet_snapshot()``."""
    st = store if store is not None else get_capsule_store()
    caps = st.sample_complete(n, seed=seed)
    reports = [replay_capsule(c, engine, store=st) for c in caps]
    summary = {
        "t": time.time(), "engine": engine.engine_id,
        "replayed": len(reports),
        "bit_exact": sum(1 for r in reports
                         if r["first_divergence"] is None),
        "divergent": [
            {"cap_id": r["cap_id"], "rid": r["rid"],
             "first_divergence": r["first_divergence"],
             "expected": r["expected"], "got": r["got"]}
            for r in reports if r["first_divergence"] is not None],
        "fingerprint_mismatches": sum(
            1 for r in reports if r["fingerprint_mismatch"]),
    }
    st.record_audit(summary)
    return summary
