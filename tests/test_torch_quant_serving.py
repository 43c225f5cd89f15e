"""Quantized and split-path serving against the reference engine.

The reference's tiny Llama (and tiny Qwen2-MoE) is built after
``paddle.seed(0)`` and carried into the port; both ``LLMEngine``s serve
the same prompts on the CPU in f32 with the same knobs: the unified
step or the split path (``unified_step=False``: the reference runs its
on-device decode windows, ``scan_decode=True``), float or int8 KV pools,
float or int8 weights, ``steps_per_sync`` 1 or 4.  Greedy tokens must
be equal, each request with its own budget so windows end mid-batch;
every row whose token is used keeps a top-1 margin of at least 1e-4.

Int8 pools after a run: every code within one of the reference's (page
0, the pad page, excepted) and at least 99.9 % equal; the scales of the
first layer within 1e-6 relative.  A later layer's rows depend on the
earlier layers' dequantized pages, so one code that rounds the other
way at a .5 boundary there (the two frameworks sum the projections in
another order) moves a later layer's absmax by up to about 1e-4
relative: its scales are held to 1e-4.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.engine import LLMEngine as RefEngine
from paddle_tpu.inference.paged_cache import PagedKVCache as RefCache
from paddle_tpu.models.llama import LlamaForCausalLM as RefLlama
from paddle_tpu.models.llama import llama_tiny_config as ref_tiny_config
from paddle_tpu.models.qwen2_moe import Qwen2MoeForCausalLM as RefQwen
from paddle_tpu.models.qwen2_moe import \
    qwen2_moe_tiny_config as ref_moe_tiny_config

from paddle_tpu_torch.inference import engine as E
from paddle_tpu_torch.inference.engine import LLMEngine
from paddle_tpu_torch.inference.paged_cache import PagedKVCache
from paddle_tpu_torch.models.from_jax import load_raw_state_dict
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.models.qwen2_moe import (Qwen2MoeForCausalLM,
                                               qwen2_moe_tiny_config)

P = 8
GEOM = dict(max_seqs=8, max_len=64, page_size=P, n_pages=64)
PROMPTS = [[5, 9, 2, 14],                         # sub-page
           list(range(1, 20)),                    # 2.5 pages
           [7] * 33,                              # page-crossing
           [3, 1, 4, 1, 5, 9, 2, 6],              # exactly one page
           list(range(40, 51))]                   # 1.5 pages
BUDGETS = [9, 6, 9, 7, 8]
SYSTEM = list(range(100, 117))                    # 2 pages + 1 token
PAIR = [SYSTEM + [1, 2, 3], SYSTEM + [9, 8]]
MARGIN = 1e-4


def _carry(ref, port):
    ref.eval()
    load_raw_state_dict(port, {k: np.asarray(v)
                               for k, v in ref.raw_state_dict().items()})
    return ref, port


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    return _carry(RefLlama(ref_tiny_config()),
                  LlamaForCausalLM(llama_tiny_config(), device="cpu"))


@pytest.fixture(scope="module")
def moe_models():
    paddle.seed(0)
    return _carry(RefQwen(ref_moe_tiny_config()),
                  Qwen2MoeForCausalLM(qwen2_moe_tiny_config(),
                                      device="cpu"))


def _margin(logits):
    top2 = logits.float().topk(2, dim=-1).values
    return float((top2[..., 0] - top2[..., 1]).min())


def _logits(out):
    return out[0] if isinstance(out, tuple) else out


@pytest.fixture
def margins(monkeypatch):
    """The port's smallest top-1 margin over the rows whose token is
    used: every prefill chunk's logits, each live descriptor's last row
    of a unified step, each live row of a split forward."""
    seen = []
    mixed, chunk, decode = (E._mixed_forward, E._paged_prefill_chunk,
                            E._decode_forward)

    def mixed_rec(*args, **kw):
        out = mixed(*args, **kw)
        q_start, q_len = args[9], args[10]
        rows = (q_start + q_len - 1)[q_len > 0].long()
        seen.append(_margin(_logits(out)[rows]))
        return out

    def chunk_rec(*args, **kw):
        out = chunk(*args, **kw)
        seen.append(_margin(_logits(out)))
        return out

    def decode_rec(*args, **kw):
        out = decode(*args, **kw)
        seen.append(_margin(_logits(out)[kw["live"]]))
        return out

    monkeypatch.setattr(E, "_mixed_forward", mixed_rec)
    monkeypatch.setattr(E, "_paged_prefill_chunk", chunk_rec)
    monkeypatch.setattr(E, "_decode_forward", decode_rec)
    yield seen
    assert seen and min(seen) >= MARGIN, \
        f"top-1 margin {min(seen)} below {MARGIN}: pick another seed"


def _serve(eng, prompts=PROMPTS, budgets=BUDGETS, admit="add_request",
           eos=None, tag="r"):
    for i, (p, n) in enumerate(zip(prompts, budgets)):
        getattr(eng, admit)(f"{tag}{i}", p, max_new_tokens=n,
                            eos_token_id=eos)
    while eng.has_work():
        eng.step()
    return [eng.result(f"{tag}{i}") for i in range(len(prompts))]


def _check_pools(ref_eng, port_eng):
    """Int8 pools: codes within one, 99.9 % equal; scales of layer 0
    within 1e-6 relative, of every layer within 1e-4 (page 0 skipped)."""
    rc, pc = ref_eng.cache, port_eng.cache
    for want, got in ((rc.k_pages, pc.k_pages), (rc.v_pages, pc.v_pages)):
        d = np.abs(np.asarray(want)[:, :, 1:].astype(np.int32)
                   - got.numpy()[:, :, 1:].astype(np.int32))
        assert d.max() <= 1 and (d == 0).mean() >= 0.999
    for want, got in ((rc.k_scales, pc.k_scales),
                      (rc.v_scales, pc.v_scales)):
        want = np.asarray(want)[:, :, 1:]
        got = got.numpy()[:, :, 1:]
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=0)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)


def _pair(models, ref_kw=(), **kw):
    ref, port = models
    return (RefEngine(ref, **GEOM, **dict(ref_kw), **kw),
            LLMEngine(port, device="cpu", **GEOM, **kw))


@pytest.mark.parametrize("sps", [1, 4], ids=["sps1", "sps4"])
@pytest.mark.parametrize("weights", [None, "int8"], ids=["w_float", "w_int8"])
@pytest.mark.parametrize("kv", [None, "int8"], ids=["kv_float", "kv_int8"])
@pytest.mark.parametrize("unified", [True, False], ids=["unified", "split"])
def test_greedy_tokens_equal_reference(models, margins, unified, kv,
                                       weights, sps):
    ref_eng, port_eng = _pair(models, unified_step=unified, kv_dtype=kv,
                              weight_dtype=weights, steps_per_sync=sps)
    want = _serve(ref_eng)
    got = _serve(port_eng)
    assert got == want
    assert [len(t) for t in got] == BUDGETS
    if kv == "int8":
        _check_pools(ref_eng, port_eng)
    if weights == "int8":
        assert isinstance(port_eng._layers[0][1], tuple)
        assert port_eng._layers[0][1][0].dtype == torch.int8


def test_split_window_stops_early_at_eos(models, margins):
    """One request on the split path with steps_per_sync 4 and an EOS
    that the model emits inside a window: the window stops there, the
    cache advanced by the steps run, and the tokens equal the
    reference's."""
    ref, port = models
    probe = LLMEngine(port, device="cpu", **GEOM, unified_step=False)
    free_run = _serve(probe, [PROMPTS[1]], [8])[0]
    eos = free_run[2]
    assert eos not in free_run[:2]
    ref_eng, port_eng = _pair(models, unified_step=False, steps_per_sync=4,
                              kv_dtype="int8")
    want = _serve(ref_eng, [PROMPTS[1]], [8], eos=eos)
    port_eng.add_request("r0", PROMPTS[1], max_new_tokens=8,
                         eos_token_id=eos)
    port_eng.step()
    assert port_eng.last_window_steps == 2        # of a 4-step window
    assert port_eng.result("r0") == want[0] == free_run[:3]


def test_moe_split_int8_tokens_and_counts_equal_reference(moe_models,
                                                          margins):
    ref, port = moe_models
    kw = dict(unified_step=False, kv_dtype="int8", weight_dtype="int8",
              steps_per_sync=4, moe_dispatch="grouped")
    ref_eng = RefEngine(ref, **GEOM, **kw)
    port_eng = LLMEngine(port, device="cpu", **GEOM, **kw)
    want = _serve(ref_eng)
    got = _serve(port_eng)
    assert got == want
    np.testing.assert_array_equal(port_eng._moe_counts.numpy(),
                                  ref_eng._moe_counts)
    egw = port_eng._layers[0][10]
    assert egw[0].dtype == torch.int8 and egw[1].shape == (8, 32)
    _check_pools(ref_eng, port_eng)


@pytest.mark.parametrize("admit", ["begin_request", "add_request"])
def test_int8_shared_prefix_pair_equal_reference(models, margins, admit):
    """The second request maps the first one's two full system-prompt
    pages (codes and scales) and prefills only its tail."""
    outs = []
    for eng in _pair(models, kv_dtype="int8"):
        toks = [_serve(eng, [p], [5], admit=admit, tag=f"p{i}")[0]
                for i, p in enumerate(PAIR)]
        outs.append((toks, dict(eng.prefix_stats), eng))
    (want, want_stats, ref_eng), (got, got_stats, port_eng) = outs
    assert got == want and got_stats == want_stats
    assert got_stats["hit_tokens"] == 2 * P and got_stats["shared_pages"] == 2
    _check_pools(ref_eng, port_eng)


def _caches(kv_dtype, layers=2):
    geom = dict(n_pages=16, page_size=P, n_kv_heads=2, head_dim=16,
                max_seqs=4, max_len=32, num_layers=layers,
                kv_dtype=kv_dtype)
    return RefCache(dtype=np.float32, **geom), PagedKVCache(device="cpu",
                                                             **geom)


def _assert_caches_equal(ref, port):
    np.testing.assert_array_equal(port.k_pages.numpy(),
                                  np.asarray(ref.k_pages))
    np.testing.assert_array_equal(port.v_pages.numpy(),
                                  np.asarray(ref.v_pages))
    if port.k_scales is not None:
        np.testing.assert_array_equal(port.k_scales.numpy(),
                                      np.asarray(ref.k_scales))
        np.testing.assert_array_equal(port.v_scales.numpy(),
                                      np.asarray(ref.v_scales))


@pytest.mark.parametrize("kv", [None, "int8"], ids=["float", "int8"])
def test_cache_append_and_attend_equal_reference(kv):
    """``PagedKVCache.append`` then ``attend`` (the plain version of #6 on
    CPU tensors) against the reference cache's, with
    ``use_kernel=False``; one slot crosses a page."""
    rng = np.random.default_rng(0)
    ref, port = _caches(kv)
    slots = [ref.allocate(6), ref.allocate(3)]
    assert [port.allocate(6), port.allocate(3)] == slots
    for _ in range(10):
        k, v = (rng.standard_normal((2, 2, 2, 16)).astype(np.float32)
                for _ in range(2))
        ref.append(slots, k, v)
        port.append(slots, torch.tensor(k), torch.tensor(v))
    _assert_caches_equal(ref, port)
    q = rng.standard_normal((2, 4, 16)).astype(np.float32)
    for layer in (0, 1):
        want = np.asarray(ref.attend(slots, q, layer, use_kernel=False))
        got = port.attend(slots, torch.tensor(q), layer).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_int8_copy_on_write_carries_the_scales():
    """A write into a shared prefix page copies the page first, its
    scale rows with it, in both caches alike."""
    rng = np.random.default_rng(1)
    ref, port = _caches("int8", layers=1)
    ids = list(range(2 * P))
    for c in (ref, port):
        c.allocate(2 * P + 1)
    for _ in range(2 * P):
        k, v = (rng.standard_normal((1, 1, 2, 16)).astype(np.float32)
                for _ in range(2))
        ref.append([0], k, v)
        port.append([0], torch.tensor(k), torch.tensor(v))
    for c in (ref, port):
        assert c.register_prefix(0, ids) == 2
        n, pages = c.lookup_prefix(ids)
        b = c.allocate(2 * P, shared_pages=pages)
        c.set_len(b, P + 3)
        c.extend(b, 1)                   # a write into shared page 1
    assert port.page_table[1].tolist() == ref.page_table[1].tolist()
    src, dst = int(port.page_table[0, 1]), int(port.page_table[1, 1])
    assert src != dst
    assert torch.equal(port.k_scales[:, :, dst], port.k_scales[:, :, src])
    assert torch.equal(port.v_pages[:, :, dst], port.v_pages[:, :, src])
    _assert_caches_equal(ref, port)


def test_begin_request_refused_on_the_split_path(models):
    ref_eng, port_eng = _pair(models, unified_step=False)
    for eng in (ref_eng, port_eng):
        with pytest.raises(ValueError, match="unified_step=True"):
            eng.begin_request("r", PROMPTS[0], max_new_tokens=2)


@pytest.mark.parametrize("kv", ["float32", "bfloat16"])
def test_float_kv_dtype_pools_equal_reference_tokens(models, margins, kv):
    """``kv_dtype`` naming a float dtype gives the pools that dtype (on
    the CPU under f32 weights), as the reference's does."""
    ref_eng, port_eng = _pair(models, kv_dtype=kv)
    assert port_eng.cache.k_pages.dtype == getattr(torch, kv)
    assert _serve(port_eng) == _serve(ref_eng)
