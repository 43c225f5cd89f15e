"""The serving runtime over the port's engine on the card.

Marked ``cuda``; every test skips on a machine without a CUDA device.
This file imports neither JAX nor the reference package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_serving.py

A small Llama (f32, head_dim 64 as the flash kernel is built for,
pages of 8) is served through ``start_http_frontend``
over a ``Scheduler``: two requests stream ``/v1/completions`` one after
the other, and each streamed token list must equal the tokens of the
same engine configuration driven directly (the same kernels, #1 and #2,
on the same admission order).  The loop thread owns every launch; it is
alive at the end, ``/healthz`` is ok and ``/statusz`` names the card.
"""
import dataclasses
import http.client
import json
import threading
import urllib.request

import pytest
import torch

from paddle_tpu_torch.inference.engine import LLMEngine
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.serving import Scheduler, start_http_frontend

pytestmark = pytest.mark.cuda

PROMPTS = {"s1": ([5, 9, 2, 14, 7, 7, 3, 1, 2, 40, 11], 12),
           "s2": ([3, 3, 7], 9)}
GEOM = dict(max_seqs=4, max_len=64, page_size=8)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _stream(port, rid, prompt, n):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request("POST", "/v1/completions",
                 json.dumps({"prompt": prompt, "max_tokens": n, "id": rid}),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    lines = [json.loads(l) for l in resp.read().decode().splitlines()]
    conn.close()
    assert lines[-1]["done"] and lines[-1]["state"] == "finished"
    return [t for l in lines for t in l.get("tokens", [])]


def test_http_frontend_streams_the_direct_engine_tokens(dev):
    torch.manual_seed(0)
    cfg = dataclasses.replace(llama_tiny_config(), hidden_size=256,
                              intermediate_size=512)     # head_dim 64
    model = LlamaForCausalLM(cfg, device=dev)
    want = {}
    for rid, (prompt, n) in PROMPTS.items():
        eng = LLMEngine(model, device=dev, **GEOM)
        eng.add_request(rid, prompt, max_new_tokens=n)
        while eng.has_work():
            eng.step()
        want[rid] = eng.result(rid)
    fe = start_http_frontend(Scheduler(LLMEngine(model, device=dev,
                                                 **GEOM)))
    try:
        got = {rid: _stream(fe.port, rid, p, n)
               for rid, (p, n) in PROMPTS.items()}
        hz = json.loads(urllib.request.urlopen(fe.url + "/healthz",
                                               timeout=60).read())
        st = json.loads(urllib.request.urlopen(fe.url + "/statusz",
                                               timeout=60).read())
        alive = fe._loop_thread.is_alive()
    finally:
        fe.shutdown()
    assert got == want
    assert alive and fe.loop_error is None
    assert hz["status"] == "ok"
    assert st["build"]["device_name"] == torch.cuda.get_device_name(dev)
    assert st["build"]["cuda"] == torch.version.cuda
    assert not [t.name for t in threading.enumerate()
                if t.name.startswith("paddle-tpu-")]
