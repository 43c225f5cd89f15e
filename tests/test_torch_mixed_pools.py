"""KV pools in another float dtype than the activations (the mixed-dtype
mode of kernels #1, #6 and #7), the port against the reference, on the
CPU.

Kernels: the same numpy inputs go through the reference's jnp oracles
(``paddle_tpu/ops/pallas/paged_attention.py``: ``paged_attention_
reference``, ``paged_decode_append_attend_reference``,
``ragged_paged_append_attend_reference``) and the port's plain versions,
in both mixed directions: f32 q and rows over bf16 pools, and bf16 q and
rows over f32 pools.  The new rows are cast to the pool dtype when they
are written (round to nearest even in both frameworks), so the pools
must be equal bit for bit; outputs come back in q's dtype: f32 within
1e-5 relative L2 (f32 sums in another order), bf16 each element within
one bf16 step (at most 2^-7 of its magnitude): the rounding of an f32
result that the two frameworks may land on either side of.

Engines: the reference's tiny Llama carried into the port serves the
same prompts (five of ragged lengths with their own budgets, then a
pair sharing two full pages of a system prompt) on both ``LLMEngine``s,
as the reference's serving benches configure them: f32 weights over
bf16 pools (``dtype=bfloat16``) on the unified step and on the split
path, and bf16 weights over the default pools, which are f32 in both.
Greedy tokens and ``prefix_stats`` must be equal.  At bf16 weights the
logits are bf16 sums taken in another order, so a first differing
token is accepted only as a near tie: the port's two logits within 1e-3
of each other (printed); anything else fails.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.engine import LLMEngine as RefEngine
from paddle_tpu.models.llama import LlamaForCausalLM as RefLlama
from paddle_tpu.models.llama import llama_tiny_config as ref_tiny_config
from paddle_tpu.ops.pallas import paged_attention as R

from paddle_tpu_torch.inference import engine as E
from paddle_tpu_torch.inference.engine import LLMEngine
from paddle_tpu_torch.models.from_jax import load_raw_state_dict
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.ops import paged_attention as pa

KVH, G, D, P, MAXP, N_PAGES = 2, 2, 16, 8, 4, 24
LENS = [0, 3, P, 2 * P + 5]          # P: the append opens page 1
# (q dtype, pool dtype) of the two directions
DIRECTIONS = {"f32q_bf16pools": (torch.float32, torch.bfloat16),
              "bf16q_f32pools": (torch.bfloat16, torch.float32)}
BF16_STEP = 2.0 ** -7

GEOM = dict(max_seqs=8, max_len=64, page_size=P, n_pages=64)
PROMPTS = [[5, 9, 2, 14], list(range(1, 20)), [7] * 33,
           [3, 1, 4, 1, 5, 9, 2, 6], list(range(40, 51))]
BUDGETS = [9, 6, 9, 7, 8]
SYSTEM = list(range(100, 117))                    # 2 pages + 1 token
PAIR = [SYSTEM + [1, 2, 3], SYSTEM + [9, 8]]
NEAR_TIE = 1e-3


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _round(a, dtype):
    """An f32 numpy array rounded to ``dtype`` (returned as f32)."""
    return torch.from_numpy(a).to(dtype).float().numpy()


def _pair(a, dtype):
    """One array as the reference's jnp array and the port's tensor, both
    in ``dtype`` (the same values: a is rounded first)."""
    a = _round(a, dtype)
    return jnp.asarray(a).astype(getattr(jnp, str(dtype)[6:])), \
        torch.from_numpy(a).to(dtype)


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32), np.float32)


def _assert_out(got, want, qdt, live=slice(None)):
    got, want = _f32(got)[live], _f32(want)[live]
    if qdt == torch.float32:
        assert _rel(got, want) <= 1e-5
    else:
        assert np.all(np.abs(got - want) <= BF16_STEP * np.abs(want) + 1e-30)


def _decode_case(seed, qdt, pdt):
    rng = np.random.default_rng(seed)
    b = len(LENS)
    tables = (rng.permutation(N_PAGES - 1)[:b * MAXP] + 1).reshape(
        b, MAXP).astype(np.int32)
    f = np.float32
    q = _pair(rng.standard_normal((b, KVH * G, D)).astype(f), qdt)
    new = [_pair(rng.standard_normal((b, KVH, D)).astype(f), qdt)
           for _ in range(2)]
    pools = [_pair(rng.standard_normal((KVH, N_PAGES, P, D)).astype(f), pdt)
             for _ in range(2)]
    return q, new, pools, tables, np.asarray(LENS, np.int32)


@pytest.mark.parametrize("direction", list(DIRECTIONS))
def test_paged_attention_plain_matches_reference(direction):
    qdt, pdt = DIRECTIONS[direction]
    q, _, pools, tables, lens = _decode_case(0, qdt, pdt)
    want = R.paged_attention_reference(
        q[0], pools[0][0], pools[1][0], jnp.asarray(tables),
        jnp.asarray(lens))
    got = pa.paged_attention(q[1], pools[0][1], pools[1][1],
                             torch.from_numpy(tables), torch.from_numpy(lens))
    assert got.dtype == qdt
    live = lens > 0
    _assert_out(got, want, qdt, live)
    assert not got[~torch.from_numpy(live)].any()


@pytest.mark.parametrize("direction", list(DIRECTIONS))
def test_paged_decode_append_plain_matches_reference(direction):
    """The appended rows are the pool dtype's rounding of the new rows,
    and the query attends over them."""
    qdt, pdt = DIRECTIONS[direction]
    q, new, pools, tables, lens = _decode_case(1, qdt, pdt)
    out, k_ref, v_ref = R.paged_decode_append_attend_reference(
        q[0], pools[0][0], pools[1][0], new[0][0], new[1][0],
        jnp.asarray(tables), jnp.asarray(lens))
    kp, vp = pools[0][1].clone(), pools[1][1].clone()
    got = pa.paged_decode_append_attend(
        q[1], kp, vp, new[0][1], new[1][1], torch.from_numpy(tables),
        torch.from_numpy(lens))
    assert got.dtype == qdt and kp.dtype == pdt
    _assert_out(got, out, qdt)
    np.testing.assert_array_equal(_f32(kp), _f32(k_ref))
    np.testing.assert_array_equal(_f32(vp), _f32(v_ref))
    row = 2                          # length P: slot 0 of its second page
    np.testing.assert_array_equal(
        _f32(kp[:, tables[row, 1], 0]),
        _f32(new[0][1][row].to(pdt)))


@pytest.mark.parametrize("direction", list(DIRECTIONS))
def test_ragged_plain_matches_reference(direction):
    """#1 in descriptor form (decode rows, a whole-page chunk, a chunk
    inside a page) against the reference's per-row form."""
    qdt, pdt = DIRECTIONS[direction]
    rng = np.random.default_rng(4)
    descs = [(0, 1), (5, 1), (P, P), (2 * P + 1, 3)]     # (kv_len, q_len)
    t = sum(ql for _, ql in descs) + 2
    q_start, q_len, kv_len = (np.zeros(t, np.int32) for _ in range(3))
    tables = np.zeros((t, MAXP), np.int32)
    positions = np.zeros(t, np.int32)
    row_tables = np.zeros((t, MAXP), np.int32)
    desc_rows, row = [], 0
    for d, (kl, ql) in enumerate(descs):
        q_start[d], q_len[d], kv_len[d] = row, ql, kl
        tables[d] = np.arange(1, MAXP + 1) + d * MAXP
        positions[row:row + ql] = np.arange(kl, kl + ql)
        row_tables[row:row + ql] = tables[d]
        desc_rows += [(d, j) for j in range(ql)]
        row += ql
    f = np.float32
    q = _pair(rng.standard_normal((t, KVH * G, D)).astype(f), qdt)
    new = [_pair(rng.standard_normal((t, KVH, D)).astype(f), qdt)
           for _ in range(2)]
    pools = [_pair(rng.standard_normal((KVH, N_PAGES, P, D)).astype(f), pdt)
             for _ in range(2)]
    ref = R.ragged_paged_append_attend_reference(
        q[0], pools[0][0], pools[1][0], new[0][0], new[1][0],
        jnp.asarray(positions), jnp.asarray(row_tables))
    kp, vp = pools[0][1].clone(), pools[1][1].clone()
    out = pa.ragged_paged_append_attend(
        q[1], kp, vp, new[0][1], new[1][1],
        *(torch.from_numpy(x) for x in (q_start, q_len, kv_len, tables)))
    assert out.dtype == qdt
    n = len(desc_rows)
    d_idx, off = (torch.tensor(x) for x in zip(*desc_rows))
    _assert_out(out[d_idx, off], np.asarray(ref[0], np.float32)[:n], qdt)
    for mine, theirs in ((kp, ref[1]), (vp, ref[2])):
        # page 0: the reference's pad rows write there, the port's do not
        np.testing.assert_array_equal(_f32(mine)[:, 1:], _f32(theirs)[:, 1:])


# -- engines -------------------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    """(reference, port) tiny Llamas with the same weights, in f32 and in
    bf16 (both cast from the f32 weights, buffers included, as each
    framework's ``to`` does)."""
    paddle.seed(0)
    ref = RefLlama(ref_tiny_config())
    ref.eval()
    arrays = {k: np.asarray(v) for k, v in ref.raw_state_dict().items()}
    out = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        port = LlamaForCausalLM(llama_tiny_config(), device="cpu")
        load_raw_state_dict(port, arrays)
        if dt == torch.bfloat16:
            ref_b = RefLlama(ref_tiny_config())
            ref_b.eval()
            ref_b.set_state_dict(ref.state_dict())
            out[name] = (ref_b.to(dtype="bfloat16"), port.to(dt))
        else:
            out[name] = (ref, port)
    return out


def _serve(eng):
    """The five prompts with their budgets (the first two deferred when
    the engine takes ``begin_request``), then the shared-prefix pair one
    after the other."""
    deferred = eng.unified_step
    for i, (p, n) in enumerate(zip(PROMPTS, BUDGETS)):
        admit = eng.begin_request if deferred and i < 2 else eng.add_request
        admit(f"r{i}", p, max_new_tokens=n)
    while eng.has_work():
        eng.step()
    toks = [eng.result(f"r{i}") for i in range(len(PROMPTS))]
    for i, p in enumerate(PAIR):
        eng.add_request(f"p{i}", p, max_new_tokens=5)
        while eng.has_work():
            eng.step()
        toks.append(eng.result(f"p{i}"))
    return toks, dict(eng.prefix_stats)


def _first_token_logits(port, prompt):
    """The port engine's f32 logits of the token after ``prompt``."""
    eng = LLMEngine(port, device="cpu", **GEOM)
    slot = eng.cache.allocate(len(prompt) + 1)
    return eng._prefill_seq(slot, prompt, 0).float()


CASES = {
    "f32w_bf16kv_unified": ("f32", dict(dtype=torch.bfloat16)),
    "f32w_bf16kv_split": ("f32", dict(dtype=torch.bfloat16,
                                      unified_step=False, steps_per_sync=4)),
    "bf16w_default_pools": ("bf16", {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_greedy_tokens_equal_reference(models, case):
    weights, kw = CASES[case]
    ref, port = models[weights]
    ref_kw = dict(kw)
    if "dtype" in kw:
        ref_kw["dtype"] = jnp.bfloat16
    ref_eng = RefEngine(ref, **GEOM, **ref_kw)
    port_eng = LLMEngine(port, device="cpu", **GEOM, **kw)
    want_dtype = kw.get("dtype", torch.float32)
    assert port_eng.cache.k_pages.dtype == want_dtype
    assert str(ref_eng.cache.k_pages.dtype) == str(want_dtype)[6:]
    want, want_stats = _serve(ref_eng)
    got, got_stats = _serve(port_eng)
    assert got_stats == want_stats
    prompts = PROMPTS + PAIR
    for p, g, w in zip(prompts, got, want):
        assert len(g) == len(w)
        if g == w:
            continue
        assert weights == "bf16", f"tokens {g} != reference {w}"
        j = next(i for i, (a, b) in enumerate(zip(g, w)) if a != b)
        logits = _first_token_logits(port, p + g[:j])
        gap = abs(float(logits[g[j]] - logits[w[j]]))
        print(f"near tie after {len(p) + j} tokens: token {g[j]} "
              f"{float(logits[g[j]]):.6f} vs reference's {w[j]} "
              f"{float(logits[w[j]]):.6f}")
        assert gap <= NEAR_TIE, f"not a near tie: logits {gap} apart"


def test_engine_hands_the_kernel_rows_in_the_activation_dtype(models,
                                                             monkeypatch):
    """The engine hands the kernels the rows in the activation dtype:
    the cast to the pools' dtype happens in the kernel's append."""
    _, port = models["f32"]
    seen = []
    ragged = pa.ragged_paged_append_attend

    def spy(q, kp, vp, kn, vn, *rest):
        seen.append((q.dtype, kn.dtype, kp.dtype))
        return ragged(q, kp, vp, kn, vn, *rest)
    monkeypatch.setattr(E, "ragged_paged_append_attend", spy)
    eng = LLMEngine(port, device="cpu", **GEOM, dtype=torch.bfloat16)
    eng.begin_request("a", PROMPTS[0], max_new_tokens=2)
    while eng.has_work():
        eng.step()
    assert seen and set(seen) == {(torch.float32, torch.float32,
                                   torch.bfloat16)}
