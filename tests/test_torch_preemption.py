"""Preemption, swap, migration and rollback in the port, against the
reference, on the CPU.

The cache cases restate ``tests/test_preemption.py``'s contracts on the
port's ``PagedKVCache``: written pages (and int8 scale rows) round-trip
through the bounded host pool byte for byte; shared prefix pages are
unpinned and re-pinned by chain key, never copied; a full or disabled
pool and an evicted shared page or too few free pages degrade to the
recompute signal (``None``); ``drop_swap`` is idempotent; a swap entry
exported from one cache imports into another of the same geometry (bf16
pages as their bit patterns) and a mismatched one raises; ``rollback``
moves only the length.

The engine cases run the same script of admissions, steps,
``suspend``/``resume`` (both restore paths), ``abort``,
``export_request``/``import_request`` on the reference's ``LLMEngine``
and the port's, over the reference's tiny Llama carried into the port
(f32; also f32 weights over bf16 pools and int8 pools).  Greedy tokens
must equal the reference's, and a preempted request's tokens must equal
those of a run that was never preempted.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.engine import LLMEngine as RefEngine
from paddle_tpu.models.llama import LlamaForCausalLM as RefLlama
from paddle_tpu.models.llama import llama_tiny_config as ref_tiny_config

from paddle_tpu_torch.inference import engine as E
from paddle_tpu_torch.inference.engine import LLMEngine
from paddle_tpu_torch.inference.paged_cache import PagedKVCache
from paddle_tpu_torch.models.from_jax import load_raw_state_dict
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny_config

GEOM = dict(max_seqs=4, max_len=64, page_size=8)
_DIRECT = {}


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    ref = RefLlama(ref_tiny_config())
    ref.eval()
    port = LlamaForCausalLM(llama_tiny_config(), device="cpu")
    load_raw_state_dict(port, {k: np.asarray(v)
                               for k, v in ref.raw_state_dict().items()})
    return ref, port


def _engines(models, **kw):
    """The reference engine and the port's, same geometry and knobs (the
    reference's ``dtype`` spelled as its numpy/jnp dtype)."""
    ref, port = models
    ref_kw = dict(kw)
    if "dtype" in kw:
        import jax.numpy as jnp
        ref_kw["dtype"] = getattr(jnp, str(kw["dtype"]).split(".")[-1])
    geom = dict(GEOM, **kw.pop("geom", {}))
    ref_kw.pop("geom", None)
    return (RefEngine(ref, **geom, **ref_kw),
            LLMEngine(port, device="cpu", **geom, **kw))


def _drain(eng):
    while eng.has_work():
        eng.step()


def _direct(models, prompt, n, **kw):
    """Tokens of an unpreempted run on the port's engine, checked equal
    to the reference's (cached per case)."""
    key = (tuple(prompt), n, tuple(sorted((k, str(v)) for k, v in
                                          kw.items())))
    if key not in _DIRECT:
        outs = []
        for eng in _engines(models, **kw):
            eng.add_request("ref", prompt, max_new_tokens=n)
            _drain(eng)
            outs.append(eng.result("ref"))
        assert outs[0] == outs[1]
        _DIRECT[key] = outs[1]
    return _DIRECT[key]


def _both(models, script, **kw):
    """Run ``script(engine)`` on the reference's engine and the port's;
    returns both results, which must be equal."""
    got = [script(eng) for eng in _engines(models, **kw)]
    assert got[1] == got[0]
    return got[1]


# -- cache: swap round trip ----------------------------------------------------
def _mk_cache(**kw):
    cfg = dict(n_pages=9, page_size=4, n_kv_heads=1, head_dim=4,
               max_seqs=2, max_len=16, num_layers=2, swap_pool_pages=8,
               device="cpu")
    cfg.update(kw)
    return PagedKVCache(**cfg)


def _fill(cache, slot, n_tok, seed=0):
    """Append n_tok random K/V rows to ``slot`` in every layer."""
    g = torch.Generator().manual_seed(seed)
    L, kvh, d = cache.num_layers, cache.k_pages.shape[1], cache.k_pages.shape[-1]
    for _ in range(n_tok):
        k, v = (torch.randn((L, 1, kvh, d), generator=g) for _ in range(2))
        cache.append([slot], k, v)


def test_swap_roundtrip_bytes_exact():
    cache = _mk_cache()
    slot = cache.allocate(10)
    _fill(cache, slot, 7)
    before = cache.k_pages.clone(), cache.v_pages.clone()
    pages_before = list(cache._pages[slot])
    handle = cache.swap_out(slot)
    assert handle is not None
    assert cache.free_pages() == cache.n_pages - 1    # all device freed
    assert cache.swap_pool_used() == 2                # 2 written pages
    cache.k_pages.zero_()                             # the device copy is gone
    cache.v_pages.zero_()
    slot2 = cache.swap_in(handle, 10)
    assert slot2 is not None
    cache.set_len(slot2, 7)
    for i in range(2):                                # written pages
        src, dst = pages_before[i], cache._pages[slot2][i]
        assert torch.equal(before[0][:, :, src], cache.k_pages[:, :, dst])
        assert torch.equal(before[1][:, :, src], cache.v_pages[:, :, dst])
    assert cache.swap_pool_used() == 0                # pool space freed
    assert len(cache._pages[slot2]) == 3              # full budget again


def test_swap_pool_bound_falls_back_to_release():
    cache = _mk_cache(swap_pool_pages=1)              # < 2 written pages
    slot = cache.allocate(8)
    _fill(cache, slot, 8)
    assert cache.swap_out(slot) is None
    assert cache.free_pages() == cache.n_pages - 1    # still released
    assert cache.swap_pool_used() == 0


def test_swap_disabled_always_falls_back():
    cache = _mk_cache(swap_pool_pages=0)
    slot = cache.allocate(4)
    _fill(cache, slot, 4)
    assert cache.swap_out(slot) is None
    assert cache.free_pages() == cache.n_pages - 1


def test_swap_shared_prefix_pages_unpinned_not_copied():
    cache = _mk_cache()
    a = cache.allocate(8)
    tokens = list(range(1, 9))
    _fill(cache, a, 8)
    cache.register_prefix(a, tokens)
    n_cached, shared = cache.lookup_prefix(tokens)
    assert n_cached == 8 and len(shared) == 2
    b = cache.allocate(12, shared_pages=shared)
    cache.set_len(b, 8)
    assert all(cache.page_ref_count(p) == 2 for p in shared)
    handle = cache.swap_out(b)
    assert cache.swap_pool_used() == 0                # nothing private
    assert all(cache.page_ref_count(p) == 1 for p in shared)  # unpinned
    slot = cache.swap_in(handle, 12)
    assert slot is not None
    assert cache._pages[slot][:2] == shared           # re-pinned by key
    assert all(cache.page_ref_count(p) == 2 for p in shared)
    cache.release(slot)
    cache.release(a)


def test_swap_in_fails_cleanly_when_shared_page_evicted():
    cache = _mk_cache(n_pages=6)                      # 5 usable
    a = cache.allocate(4)
    tokens = [9, 8, 7, 6]
    _fill(cache, a, 4)
    cache.register_prefix(a, tokens)
    _, shared = cache.lookup_prefix(tokens)
    b = cache.allocate(8, shared_pages=shared)
    cache.set_len(b, 4)
    handle = cache.swap_out(b)
    cache.release(a)                                  # prefix page -> LRU
    c = cache.allocate(16)                            # evicts it
    d = cache.allocate(4)
    assert cache.cached_page_count() == 0
    assert cache.swap_in(handle, 8) is None           # recompute signal
    cache.release(c)
    cache.release(d)


def test_swap_in_fails_cleanly_when_pages_short():
    cache = _mk_cache(max_seqs=3)
    slot = cache.allocate(8)
    _fill(cache, slot, 8)
    handle = cache.swap_out(slot)
    hog1 = cache.allocate(16)                         # 4 of 8 pages
    hog2 = cache.allocate(12)                         # 3 more
    assert cache.swap_in(handle, 8) is None           # 2 needed, 1 free
    assert cache.swap_pool_used() == 0                # entry consumed
    assert cache.free_pages() == 1
    cache.release(hog1)
    cache.release(hog2)


def test_drop_swap_idempotent():
    cache = _mk_cache()
    slot = cache.allocate(4)
    _fill(cache, slot, 4)
    handle = cache.swap_out(slot)
    assert cache.drop_swap(handle) is True
    assert cache.drop_swap(handle) is False           # already gone
    assert cache.drop_swap(None) is False             # recompute path
    assert cache.swap_pool_used() == 0
    assert cache.swap_in(handle, 4) is None           # dropped entry


@pytest.mark.parametrize("dtype,kv_dtype", [
    (torch.float32, None), (torch.bfloat16, None), (torch.float32, "int8")],
    ids=["f32", "bf16", "int8"])
def test_exported_swap_imports_into_another_cache(dtype, kv_dtype):
    """The blob carries the pages (bf16 as uint16 bits, int8 codes with
    their scale rows) and the shared prefix page as data; the other
    cache restores them byte for byte.  A blob of another geometry
    raises."""
    src = _mk_cache(dtype=dtype, kv_dtype=kv_dtype)
    a = src.allocate(12)
    _fill(src, a, 9)
    src.register_prefix(a, list(range(4)), upto=4)    # page 0 registered
    pages = list(src._pages[a][:3])
    want = [p[:, :, pages].clone() for p in src._pools() if p is not None]
    blob = src.export_swap(src.swap_out(a))
    assert src.swap_pool_used() == 0 and src.export_swap(None) is None
    dst = _mk_cache(dtype=dtype, kv_dtype=kv_dtype)
    dst.allocate(4)                                   # other pages in use
    slot = dst.swap_in(dst.import_swap(blob), 12)
    got = [p[:, :, dst._pages[slot][:3]] for p in dst._pools()
           if p is not None]
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    other = _mk_cache(dtype=torch.float16 if kv_dtype is None
                      else torch.float32, head_dim=8)
    with pytest.raises(ValueError, match="geometry mismatch"):
        other.import_swap(blob)
    small = _mk_cache(dtype=dtype, kv_dtype=kv_dtype, swap_pool_pages=2)
    assert small.import_swap(blob) is None            # 3 pages do not fit


def test_rollback_moves_only_the_length():
    cache = _mk_cache()
    slot = cache.allocate(12)
    _fill(cache, slot, 9)
    pages = list(cache._pages[slot])
    before = cache.k_pages.clone()
    cache.rollback(slot, 3)
    assert int(cache.seq_lens[slot]) == 6
    assert cache._pages[slot] == pages and torch.equal(cache.k_pages, before)
    _fill(cache, slot, 1, seed=5)                     # overwrites position 6
    assert int(cache.seq_lens[slot]) == 7
    pg, off = pages[6 // 4], 6 % 4
    assert not torch.equal(cache.k_pages[:, :, pg, off],
                           before[:, :, pg, off])
    with pytest.raises(ValueError, match="holds 7"):
        cache.rollback(slot, 8)
    cache.release(slot)
    with pytest.raises(ValueError, match="free slot"):
        cache.rollback(slot, 0)


# -- engine: suspend / resume --------------------------------------------------
def test_suspend_resume_swap_in_bit_identical(models):
    want = _direct(models, [5, 9, 2, 14], 12)

    def script(eng):
        eng.add_request("x", [5, 9, 2, 14], max_new_tokens=12)
        eng.step()
        eng.step()
        slots0, pages0 = eng.capacity()
        assert eng.suspend("x") is True               # swap path armed
        slots1, pages1 = eng.capacity()
        assert slots1 == slots0 + 1 and pages1 > pages0
        assert eng.suspended_count() == 1 and not eng.has_work()
        with pytest.raises(Exception, match="still generating"):
            eng.result("x")
        assert eng.resume("x") == "swap_in"
        _drain(eng)
        return eng.result("x")
    assert _both(models, script) == want


@pytest.mark.parametrize("sps", [1, 4])
def test_suspend_resume_recompute_bit_identical(models, monkeypatch, sps):
    """The recompute replays the generated tokens but the last through
    the split path's decode forward (kernel #7 on the card), one forward
    a token, in power-of-two windows."""
    want = _direct(models, [5, 9, 2, 14], 12)
    forwards = []
    decode = E._decode_forward

    def counted(*args, **kw):
        forwards.append(1)
        return decode(*args, **kw)
    monkeypatch.setattr(E, "_decode_forward", counted)

    def script(eng):
        eng.add_request("y", [5, 9, 2, 14], max_new_tokens=12)
        for _ in range(3):
            eng.step()
        assert eng.suspend("y") is False              # no swap entry
        assert eng.cache.free_pages() == eng.cache.n_pages - 1
        forwards.clear()
        assert eng.resume("y") == "recompute"
        req = eng.requests["y"]
        assert int(eng.cache.seq_lens[req.slot]) == 4 + len(req.out) - 1
        if isinstance(eng, LLMEngine):                # the port's forwards
            assert len(forwards) == len(req.out) - 1
        _drain(eng)
        return eng.result("y")
    assert _both(models, script, swap_pool_pages=0,
                 steps_per_sync=sps) == want


def test_multiple_preemption_cycles_stay_exact(models):
    want = _direct(models, [3, 3, 7], 16)

    def script(eng):
        eng.add_request("z", [3, 3, 7], max_new_tokens=16)
        paths = []
        for _ in range(3):
            eng.step()
            eng.suspend("z")
            paths.append(eng.resume("z"))
        _drain(eng)
        assert paths == ["swap_in"] * 3
        return eng.result("z")
    assert _both(models, script) == want


def test_corunner_unaffected_by_suspension(models):
    want_b = _direct(models, [3, 3, 7], 10)
    want_a = _direct(models, [5, 9, 2, 14], 12)

    def script(eng):
        eng.add_request("a", [5, 9, 2, 14], max_new_tokens=12)
        eng.add_request("b", [3, 3, 7], max_new_tokens=10)
        eng.step()
        eng.suspend("a")
        eng.step()                                    # b decodes alone
        eng.resume("a")
        _drain(eng)
        return eng.result("a"), eng.result("b")
    assert _both(models, script) == (want_a, want_b)


def test_resume_recompute_uses_prefix_cache(models):
    """The recompute finds the prompt's pages still registered (its own
    prefill published them) and prefills only the last chunk."""
    prompt = list(range(1, 18))                       # 2 full pages + 1
    want = _direct(models, prompt, 8)

    def script(eng):
        eng.add_request("p", prompt, max_new_tokens=8)
        eng.step()
        eng.suspend("p")
        assert eng.cache.cached_page_count() >= 2     # pages parked in LRU
        hits = eng.cache.lookup_prefix(prompt[:16])[0]
        assert eng.resume("p") == "recompute"
        _drain(eng)
        return hits, eng.result("p")
    assert _both(models, script, swap_pool_pages=0,
                 enable_prefix_caching=True) == (16, want)


def test_int8_kv_swap_roundtrip_exact(models):
    want = _direct(models, [5, 9, 2, 14], 10, kv_dtype="int8")

    def script(eng):
        eng.add_request("q", [5, 9, 2, 14], max_new_tokens=10)
        eng.step()
        eng.suspend("q")
        assert eng.resume("q") == "swap_in"
        _drain(eng)
        return eng.result("q")
    assert _both(models, script, kv_dtype="int8") == want


@pytest.mark.parametrize("swap", [True, False], ids=["swap_in", "recompute"])
def test_bf16_pools_under_f32_weights_preempt_exactly(models, swap):
    """The reference's serving configuration (f32 weights, bf16 pools):
    both restore paths give the unpreempted run's tokens."""
    kw = dict(dtype=torch.bfloat16, steps_per_sync=4,
              swap_pool_pages=None if swap else 0)
    want = _direct(models, list(range(1, 20)), 11, dtype=torch.bfloat16,
                   steps_per_sync=4)

    def script(eng):
        eng.begin_request("m", list(range(1, 20)), max_new_tokens=11)
        eng.step()                                    # 2.5 pages: 2 chunks
        eng.step()
        eng.step()
        assert eng.suspend("m") is swap
        path = eng.resume("m")
        _drain(eng)
        return path, eng.result("m")
    assert _both(models, script, **kw) == (
        "swap_in" if swap else "recompute", want)


def test_suspend_mid_prefill_restarts_the_prompt(models):
    prompt = list(range(1, 20))
    want = _direct(models, prompt, 6)

    def script(eng):
        eng.begin_request("w", prompt, max_new_tokens=6)
        eng.step()                                    # first chunk only
        assert eng.suspend("w") is False
        assert eng.resume("w") == "recompute"
        _drain(eng)
        return eng.result("w")
    assert _both(models, script, prefill_token_budget=8) == want


def test_abort_suspended_drops_swap_entry(models):
    def script(eng):
        eng.add_request("s", [5, 9, 2, 14], max_new_tokens=16)
        eng.step()
        eng.suspend("s")
        assert eng.cache.swap_pool_used() > 0
        assert eng.abort("s") is True
        assert eng.cache.swap_pool_used() == 0        # entry dropped
        assert eng.abort("s") is False                # idempotent
        toks = eng.result("s")                        # defined: partial
        assert len(toks) >= 1 and eng.requests["s"].cancelled
        for call in (lambda: eng.resume("s"),
                     lambda: eng.suspend("never-admitted"),
                     lambda: eng.suspend("s")):
            with pytest.raises(ValueError):
                call()
        return toks
    _both(models, script, geom=dict(max_seqs=2))


def test_capacity_is_atomic_snapshot(models):
    def script(eng):
        assert eng.capacity() == (2, eng.cache.n_pages - 1)
        eng.add_request("c", [1, 2, 3], max_new_tokens=8)
        slots, pages = eng.capacity()
        assert slots == eng.free_slots()
        assert pages == eng.cache.free_pages()
        eng.suspend("c")
        assert eng.capacity() == (2, eng.cache.n_pages - 1)
        eng.resume("c")
        assert eng.capacity() == (slots, pages)
        _drain(eng)
        return eng.result("c")
    _both(models, script, geom=dict(max_seqs=2, max_len=32),
          enable_prefix_caching=False)


# -- engine: migration ---------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("swap", [True, False], ids=["swap", "recompute"])
def test_exported_request_resumes_on_another_engine(models, swap, dtype):
    """A suspended request moves to a second engine on the same model and
    finishes there with the unpreempted run's tokens, restored from the
    blob (swap) or recomputed from its history; the first engine forgets
    it.  The reference's blob of bf16 pools does not load back (numpy
    keeps its bf16 arrays as raw 2-byte records, which ``import_swap``'s
    ``jnp.asarray`` refuses), so that case runs on the port alone,
    against the reference's unpreempted tokens."""
    prompt = list(range(3, 15))
    want = _direct(models, prompt, 10, dtype=dtype)
    kw = dict(dtype=dtype, swap_pool_pages=None if swap else 0)
    first, second = _engines(models, **kw), _engines(models, **kw)
    pairs = list(zip(first, second))                  # reference, port
    if swap and dtype == torch.bfloat16:
        pairs = pairs[1:]
    outs = []
    for src, dst in pairs:
        src.add_request("g", prompt, max_new_tokens=10)
        src.step()
        src.step()
        src.suspend("g")
        pkg = src.export_request("g")
        assert "g" not in src.requests
        assert (pkg["swap"] is not None) == swap
        dst.import_request(pkg)
        assert dst.suspended_count() == 1
        path = dst.resume("g")
        _drain(dst)
        outs.append((path, dst.result("g")))
    assert outs[-1] == outs[0] == ("swap_in" if swap else "recompute", want)
    with pytest.raises(ValueError, match="duplicate"):
        second[1].import_request(dict(pkg, out=[1]))
