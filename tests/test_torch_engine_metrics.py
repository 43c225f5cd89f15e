"""The port engine's and cache's metrics against the reference's.

The tiny Llama of ``test_torch_llama_engine.py`` (the reference model
after ``paddle.seed(0)``, its weights carried into the port) serves the
same script on both engines (``scan_decode=False``, ``enable_metrics=
True``): deferred and synchronous admission, a shared-prefix pair, a
swap-out and swap-in, an abort.  The two ``metrics_snapshot()``s must be
equal on every key but the timings (TTFT/TPOT histograms), the engine id
(a per-process counter) and the four compile counters, which are 0 in
the port (eager PyTorch compiles nothing) and the jit cache sizes in the
reference.  The caches' own snapshots, ``memory_rows``, bytes per token
and utilization must be equal for f32, bf16 and int8 pools, and
``write_prefill`` followed by ``attend`` must agree within 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.engine import LLMEngine as RefEngine
from paddle_tpu.inference.paged_cache import PagedKVCache as RefCache
from paddle_tpu.models.llama import LlamaForCausalLM as RefLlama
from paddle_tpu.models.llama import llama_tiny_config as ref_tiny_config
from paddle_tpu.observability import capsule as ref_capsule

from paddle_tpu_torch.inference.engine import LLMEngine
from paddle_tpu_torch.inference.paged_cache import PagedKVCache
from paddle_tpu_torch.models.from_jax import load_raw_state_dict
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.observability import capsule, get_registry

P = 8
GEOM = dict(max_seqs=8, max_len=64, page_size=P, n_pages=64)
PROMPTS = [[5, 9, 2, 14], list(range(1, 20)), [7] * 33,
           [3, 1, 4, 1, 5, 9, 2, 6], list(range(40, 51))]
SYSTEM = list(range(100, 117))
PAIR = [SYSTEM + [1, 2, 3], SYSTEM + [9, 8]]
# keys whose values differ by construction (see the module docstring)
TIMINGS = {"ttft_seconds", "tpot_seconds"}
COMPILES = {"prefill_compiles", "decode_compiles", "mixed_compiles",
            "window_compiles"}


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    ref = RefLlama(ref_tiny_config())
    ref.eval()
    port = LlamaForCausalLM(llama_tiny_config(), device="cpu")
    load_raw_state_dict(port, {k: np.asarray(v)
                               for k, v in ref.raw_state_dict().items()})
    return ref, port


def _script(eng):
    """Admissions (two sharing a 2-page prefix), steps, a suspend with
    swap-out and a resume by swap-in, an abort; returns every result."""
    eng.add_request("s0", PAIR[0], max_new_tokens=4)
    eng.begin_request("s1", PAIR[1], max_new_tokens=4)
    eng.begin_request("a", PROMPTS[1], max_new_tokens=6)
    eng.add_request("b", PROMPTS[2], max_new_tokens=6)
    eng.begin_request("c", PROMPTS[4], max_new_tokens=5)
    for _ in range(2):
        eng.step()
    assert eng.suspend("b")
    eng.step()
    assert eng.resume("b") == "swap_in"
    eng.step()
    assert eng.abort("a")
    while eng.has_work():
        eng.step()
    return {rid: eng.result(rid) for rid in ("s0", "s1", "a", "b", "c")}


def test_metrics_snapshot_equals_the_reference(models):
    ref, port = models
    r = RefEngine(ref, **GEOM, scan_decode=False, enable_metrics=True)
    p = LLMEngine(port, device="cpu", **GEOM)       # metrics on by default
    assert _script(p) == _script(r)
    got, want = p.metrics_snapshot(), r.metrics_snapshot()
    assert set(got) == set(want)
    assert {k: got[k] for k in COMPILES} == dict.fromkeys(COMPILES, 0)
    for k in sorted(set(want) - TIMINGS - COMPILES - {"engine"}):
        assert got[k] == want[k], k
    # the timing histograms count the same observations
    for k in TIMINGS:
        assert got[k]["count"] == want[k]["count"] > 0, k
    assert got["kv_cache"]["swap_in_pages"] > 0
    assert got["prefix_caching"]["hit_tokens"] == 16
    # the registry's series of this engine and its cache
    text = get_registry().expose_text()
    eid, cid = p.engine_id, p.cache.cache_id
    assert f'llm_engine_aborted_total{{engine="{eid}"}} 1' in text
    assert f'llm_engine_resumed_total{{engine="{eid}",path="swap_in"}} 1' \
        in text
    assert f'kv_cache_swap_in_pages_total{{cache="{cid}"}} ' \
        f'{got["kv_cache"]["swap_in_pages"]}' in text
    assert "eager PyTorch compiles no programs" in text


def test_config_fingerprint_hashes_the_config_alike(models):
    ref, port = models
    r = RefEngine(ref, **GEOM, scan_decode=False)
    p = LLMEngine(port, device="cpu", **GEOM)
    got, want = p.config_fingerprint(), r.config_fingerprint()
    assert got["model_hash"] == want["model_hash"] == \
        capsule.model_fingerprint(port) == ref_capsule.model_fingerprint(ref)
    assert set(got) == set(want)
    for k in sorted(set(want) - {"engine"}):
        assert got[k] == want[k], k


POOLS = {"f32": (torch.float32, jnp.float32, None),
         "bf16": (torch.bfloat16, jnp.bfloat16, None),
         "int8": (torch.float32, jnp.float32, "int8")}


def _cache_script(cache, k, v, q, to_dev):
    """write_prefill, prefix registration and a shared allocation,
    copy-on-write, swap-out / swap-in and releases on one cache; returns
    the attention of q over three slots after the writes."""
    s0 = cache.allocate(40)
    cache.write_prefill(s0, to_dev(k[:, :19]), to_dev(v[:, :19]))
    toks = list(range(19))
    cache.register_prefix(s0, toks, upto=16)
    hit, shared = cache.lookup_prefix(toks[:16])
    assert hit == 16
    s1 = cache.allocate(30, shared_pages=shared)
    cache.set_len(s1, 12)               # the write copies shared page 1
    cache.write_prefill(s1, to_dev(k[:, 19:25]), to_dev(v[:, 19:25]))
    s2 = cache.allocate(12)
    cache.write_prefill(s2, to_dev(k[:, 25:30]), to_dev(v[:, 25:30]))
    out = [cache.attend([s0, s1, s2], to_dev(q), layer=li)
           for li in range(2)]
    handle = cache.swap_out(s2)
    s3 = cache.swap_in(handle, 12)
    cache.set_len(s3, 5)
    rows = cache.memory_rows()
    h2 = cache.swap_out(s1)
    rows_swapped = cache.memory_rows()
    cache.release(s0)
    return out, rows, rows_swapped, h2


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_cache_accessors_and_write_prefill_equal_the_reference(pool):
    t_dtype, j_dtype, kv = POOLS[pool]
    geom = dict(n_pages=16, page_size=P, n_kv_heads=2, head_dim=16,
                max_seqs=4, max_len=64, num_layers=2, kv_dtype=kv,
                swap_pool_pages=16)
    rng = np.random.default_rng(3)
    k = rng.standard_normal((2, 30, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 30, 2, 16)).astype(np.float32)
    q = rng.standard_normal((3, 4, 16)).astype(np.float32)
    pc = PagedKVCache(**geom, dtype=t_dtype, device="cpu")
    rc = RefCache(**geom, dtype=j_dtype)
    p_out, p_rows, p_sw, _ = _cache_script(
        pc, k, v, q, lambda a: torch.from_numpy(a).to(t_dtype))
    r_out, r_rows, r_sw, _ = _cache_script(
        rc, k, v, q, lambda a: jnp.asarray(a, j_dtype))
    for got, want in zip(p_out, r_out):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=0, atol=1e-6)
    # the written pools themselves are equal
    np.testing.assert_array_equal(
        pc.k_pages.float().numpy(), np.asarray(rc.k_pages, np.float32))
    if kv == "int8":
        np.testing.assert_array_equal(pc.k_scales.numpy(),
                                      np.asarray(rc.k_scales))
    assert p_rows == r_rows and p_sw == r_sw
    assert p_sw["host_bytes"] > 0 and p_rows["device_bytes"] == sum(
        t.nbytes for t in (pc.k_pages, pc.v_pages, pc.k_scales,
                           pc.v_scales) if t is not None)
    assert pc.metrics_snapshot() == rc.metrics_snapshot()
    assert pc.metrics_snapshot()["cow_pages"] == 1
    assert pc.kv_bytes_per_token() == rc.kv_bytes_per_token()
    assert pc.page_utilization() == rc.page_utilization()
    assert pc.free_page_count() == rc.free_page_count() == pc.free_pages()
