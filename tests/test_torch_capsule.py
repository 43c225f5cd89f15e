"""Request capsules: capture on the port engine, replay bit-exact.

With capture on (``enable_capsule_capture``), every admission and decode
window of the port engine lands in a capsule; ``replay_capsule`` re-runs
it through the engine's own prefill and split-path decode into a
scratch slot and must find no divergence (``first_divergence is None``)
for greedy and sampled serving on the unified and split paths, int8
pools, requests resumed by swap-in and by recompute, and a capsule that
travelled in an ``export_request`` package.  A tampered capsule reports
the divergence step the reference reports for the same tampering, and a
capsule the reference engine captured replays on the port with no
divergence (the port's threefry keys are ``jax.random``'s words).  The
tiny Llama of ``test_torch_llama_engine.py`` serves in f32 on the CPU;
the capture planes of both packages are switched off after each test.
"""
import copy

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference.engine import LLMEngine as RefEngine
from paddle_tpu.models.llama import LlamaForCausalLM as RefLlama
from paddle_tpu.models.llama import llama_tiny_config as ref_tiny_config
from paddle_tpu.observability import capsule as ref_capsule

from paddle_tpu_torch.inference.engine import LLMEngine
from paddle_tpu_torch.models.from_jax import load_raw_state_dict
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.observability import capsule

P = 8
GEOM = dict(max_seqs=8, max_len=64, page_size=P, n_pages=64)
PROMPTS = {"r0": [5, 9, 2, 14], "r1": list(range(1, 20)),
           "r2": [7] * 33, "r3": list(range(40, 51))}
SAMPLING = dict(decode_strategy="sampling", top_k=8, temperature=0.9,
                seed=11)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    ref = RefLlama(ref_tiny_config())
    ref.eval()
    port = LlamaForCausalLM(llama_tiny_config(), device="cpu")
    load_raw_state_dict(port, {k: np.asarray(v)
                               for k, v in ref.raw_state_dict().items()})
    return ref, port


@pytest.fixture
def stores():
    """Capture on in both packages for the test, off after it."""
    yield capsule.enable_capsule_capture(), \
        ref_capsule.enable_capsule_capture()
    capsule.disable_capsule_capture()
    ref_capsule.disable_capsule_capture()
    assert capsule.get_capsule_store() is capsule.NULL_CAPSULE_STORE


def _serve(eng, max_new=7, preempt=None):
    """Admit the prompts (r0 and r2 synchronously, r1 and r3 deferred on
    the unified path), step to the end; ``preempt`` suspends r1 after
    three steps and resumes it a step later.  Returns the results."""
    for rid, ids in PROMPTS.items():
        deferred = eng.unified_step and rid in ("r1", "r3")
        getattr(eng, "begin_request" if deferred else "add_request")(
            rid, ids, max_new_tokens=max_new)
    steps = 0
    while eng.has_work():
        eng.step()
        steps += 1
        if preempt and steps == 3:
            eng.suspend("r1")
            eng.step()
            assert eng.resume("r1") == preempt
    return {rid: eng.result(rid) for rid in PROMPTS}


def _replays(store, eng, results, replay=capsule.replay_capsule):
    reports = {}
    for rid, toks in results.items():
        cap = store.get(rid)
        assert cap["tokens"] == toks
        reports[rid] = replay(cap, eng)
    return reports


CASES = {
    "greedy_unified": {},
    "greedy_split": dict(unified_step=False, steps_per_sync=4),
    "sampling_unified": SAMPLING,
    "sampling_split": dict(SAMPLING, unified_step=False, steps_per_sync=2),
    "int8_unified": dict(kv_dtype="int8"),
    "int8_split_sampling": dict(SAMPLING, kv_dtype="int8",
                                unified_step=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_capture_then_replay_is_bit_exact(models, stores, case):
    _, port = models
    eng = LLMEngine(port, device="cpu", **GEOM, **CASES[case])
    results = _serve(eng)
    reports = _replays(stores[0], eng, results)
    for rid, rep in reports.items():
        assert rep["first_divergence"] is None, (rid, rep)
        assert rep["steps_compared"] >= len(results[rid]) - 1
        assert rep["fingerprint_mismatch"] == []
    notes = {n for r in reports.values() for n in r["notes"]}
    # a deferred request's sampled first token drew at a prefill row
    assert notes <= {"unanchored_sampling_first_token_skipped"}
    assert stores[0].snapshot()["divergent_replays_total"] == 0


@pytest.mark.parametrize("path", ["swap_in", "recompute"])
def test_replay_after_resume(models, stores, path):
    _, port = models
    eng = LLMEngine(port, device="cpu", **GEOM, **SAMPLING,
                    swap_pool_pages=None if path == "swap_in" else 0)
    results = _serve(eng, preempt=path)
    cap = stores[0].get("r1")
    assert [e[0] for e in cap["events"]] == [
        "suspend:swap" if path == "swap_in" else "suspend:drop",
        f"resume:{path}"]
    for rid, rep in _replays(stores[0], eng, results).items():
        assert rep["first_divergence"] is None, (rid, rep)


def test_capsule_travels_in_the_migration_package(models, stores):
    _, port = models
    src = LLMEngine(port, device="cpu", **GEOM, **SAMPLING)
    dst = LLMEngine(port, device="cpu", **GEOM, **SAMPLING)
    src.add_request("m", PROMPTS["r2"], max_new_tokens=8)
    for _ in range(3):
        src.step()
    src.suspend("m")
    pkg = src.export_request("m")
    assert pkg["capsule"]["rid"] == "m" and stores[0].get("m") is None
    dst.import_request(pkg)
    assert dst.resume("m") == "swap_in"
    while dst.has_work():
        dst.step()
    out = dst.result("m")
    cap = stores[0].get("m")
    assert cap["tokens"] == out and len(out) == 8
    assert [e[0] for e in cap["events"]] == [
        "suspend:swap", "exported", "adopted", "resume:swap_in"]
    for eng in (src, dst):
        assert capsule.replay_capsule(cap, eng)["first_divergence"] is None


def _dense_logprob_delta(ref, context, want, got):
    """logp(got) - logp(want) under the reference model's own dense
    forward over ``context`` (its last position's logits, f64 on the
    host as the replay computes them): a value no engine state can race
    with, unlike the reference replay's scratch-slot prefill."""
    logits = np.asarray(ref(paddle.to_tensor(np.asarray(
        [context], np.int32))).value, np.float64)[0, -1]
    logits -= logits.max()
    logz = np.log(np.exp(logits).sum())
    return (logits[got] - logz) - (logits[want] - logz)


def test_tampered_capsule_diverges_where_the_reference_says(models, stores):
    """The divergence step and tokens are the reference replay's; the
    logprob delta is held against the reference model's dense forward
    over the prompt plus the verified tokens (1e-4), which does not read
    the reference engine's page tables."""
    ref, port = models
    ref_eng = RefEngine(ref, **GEOM, scan_decode=False)
    port_eng = LLMEngine(port, device="cpu", **GEOM)
    _serve(ref_eng)
    _serve(port_eng)
    for step in (0, 3):
        for rid in ("r0", "r1"):
            bad = copy.deepcopy(ref_capsule.get_capsule_store().get(rid))
            bad["tokens"][step] = (bad["tokens"][step] + 1) % 256
            want = ref_capsule.replay_capsule(bad, ref_eng)
            got = capsule.replay_capsule(bad, port_eng)
            assert want["first_divergence"] == step
            for k in ("first_divergence", "expected", "got",
                      "steps_compared"):
                assert got[k] == want[k], (rid, step, k)
            delta = _dense_logprob_delta(
                ref, bad["prompt"] + bad["tokens"][:step], got["expected"],
                got["got"])
            np.testing.assert_allclose(got["logprob_delta"], delta,
                                       atol=1e-4)


@pytest.mark.parametrize("case", ["greedy_split", "sampling_unified"])
def test_reference_capsule_replays_on_the_port(models, stores, case):
    ref, port = models
    knobs = dict(GEOM, **CASES[case])
    ref_eng = RefEngine(ref, scan_decode=False, **knobs)
    results = _serve(ref_eng)
    port_eng = LLMEngine(port, device="cpu", **knobs)
    reports = _replays(ref_capsule.get_capsule_store(), port_eng, results)
    for rid, rep in reports.items():
        assert rep["first_divergence"] is None, (rid, rep)
        assert rep["fingerprint_mismatch"] == []
    # and the port serves the same tokens itself
    assert _serve(port_eng) == results
