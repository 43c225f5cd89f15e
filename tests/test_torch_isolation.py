"""The port stands alone: no module of ``paddle_tpu_torch`` and not
``chip_smoke.py`` imports JAX or the reference package, and its entry
points refuse to run on the CPU unless asked to.

The import check runs in a fresh interpreter in which ``jax`` and
``paddle_tpu`` are blocked (``sys.modules[name] = None`` makes any
import of them raise), so a stray import anywhere fails the test.
"""
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from paddle_tpu_torch.common.errors import UnavailableError
from paddle_tpu_torch.inference.engine import LLMEngine
from paddle_tpu_torch.models.bert import BertForMaskedLM, bert_tiny_config
from paddle_tpu_torch.models.dit import (AutoencoderKL, DiTWithDiffusion,
                                         dit_tiny_config)
from paddle_tpu_torch.models.ernie import (Ernie45ForCausalLM,
                                           ernie45_tiny_config)
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt2_tiny_config
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.nn.conv import Conv2D
from paddle_tpu_torch.nn.norm import GroupNorm

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["paddle_tpu"] = None
import paddle_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    paddle_tpu_torch.__path__, "paddle_tpu_torch.")]
new = ["paddle_tpu_torch.hapi.model", "paddle_tpu_torch.hapi.callbacks",
       "paddle_tpu_torch.io.dataloader", "paddle_tpu_torch.io.token_dataset",
       "paddle_tpu_torch.core.build", "paddle_tpu_torch.metric",
       "paddle_tpu_torch.framework.io", "paddle_tpu_torch.visualdl"]
assert not set(new) - set(names), sorted(set(new) - set(names))
for name in names + ["chip_smoke"]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")
             and sys.modules[m] is not None)
assert not bad, bad
print(len(names))
"""


def test_port_imports_no_jax_and_no_reference_package():
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 85       # every module imported


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")


def test_entry_points_default_to_the_gpu(no_cuda):
    with pytest.raises(UnavailableError, match="device='cpu'"):
        LlamaForCausalLM(llama_tiny_config())
    with pytest.raises(UnavailableError, match="device='cpu'"):
        GPTForCausalLM(gpt2_tiny_config())
    model = LlamaForCausalLM(llama_tiny_config(), device="cpu")
    with pytest.raises(UnavailableError, match="device='cpu'"):
        LLMEngine(model, max_len=64, page_size=8)
    LLMEngine(model, max_len=64, page_size=8, device="cpu")


@pytest.mark.parametrize("make", [
    lambda: Ernie45ForCausalLM(ernie45_tiny_config()),
    lambda: DiTWithDiffusion(dit_tiny_config()),
    lambda: AutoencoderKL(base=8, groups=4),
    lambda: BertForMaskedLM(bert_tiny_config()),
    lambda: Conv2D(3, 4, 3),
    lambda: GroupNorm(2, 4)],
    ids=["ernie", "dit", "vae", "bert", "conv2d", "group_norm"])
def test_zoo_entry_points_default_to_the_gpu(no_cuda, make):
    with pytest.raises(UnavailableError, match="device='cpu'"):
        make()
