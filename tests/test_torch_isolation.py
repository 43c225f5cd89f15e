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
       "paddle_tpu_torch.framework.io", "paddle_tpu_torch.visualdl",
       "paddle_tpu_torch.distributed.env",
       "paddle_tpu_torch.distributed.store",
       "paddle_tpu_torch.distributed.strategy",
       "paddle_tpu_torch.distributed.topology",
       "paddle_tpu_torch.distributed.collective",
       "paddle_tpu_torch.distributed.fleet",
       "paddle_tpu_torch.distributed.sharding",
       "paddle_tpu_torch.distributed.trainer",
       "paddle_tpu_torch.distributed.launch",
       "paddle_tpu_torch.distributed.launch.main",
       "paddle_tpu_torch.distributed.launch.controller",
       "paddle_tpu_torch.distributed.launch.__main__",
       "paddle_tpu_torch.common.filelock"]
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
    assert int(res.stdout.split()[-1]) >= 98       # every module imported


def test_worker_of_the_gang_tests_imports_no_jax():
    """``tests/torch_dist_worker.py``, ``tests/torch_tp_worker.py`` and
    ``tests/torch_mp_worker.py`` run in the gangs' ranks: they too must
    import neither JAX nor the reference package."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['paddle_tpu'] = None; sys.path.insert(0, 'tests'); "
            "import torch_dist_worker, torch_tp_worker, torch_mp_worker, "
            "paddle_tpu_torch.distributed")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


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


@pytest.mark.parametrize("make", [
    lambda: __import__("paddle_tpu_torch.distributed",
                       fromlist=["fleet"]).fleet.init(),
    lambda: __import__("paddle_tpu_torch.distributed",
                       fromlist=["init_parallel_env"]).init_parallel_env(),
    lambda: __import__("paddle_tpu_torch.distributed",
                       fromlist=["ShardedTrainStep"]).ShardedTrainStep(
        LlamaForCausalLM(llama_tiny_config(), device="cpu"),
        lambda m, b: None, None)],
    ids=["fleet_init", "init_parallel_env", "sharded_train_step"])
def test_distributed_entry_points_default_to_the_gpu(no_cuda, make):
    """Each joins (or trains in) an NCCL gang on the card unless
    ``device="cpu"`` is passed: without a card they raise before any
    process group exists."""
    import torch.distributed as tdist
    with pytest.raises(UnavailableError, match="device='cpu'"):
        make()
    assert not tdist.is_initialized()
