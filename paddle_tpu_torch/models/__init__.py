"""The port's model zoo (counterpart of ``paddle_tpu/models``): Llama,
GPT-2, Qwen2-MoE (and DeepSeekMoE's geometry), ERNIE-4.5, BERT, DiT with
its KL autoencoder, and the checkpoint converters (``convert``) and the
reference-weight loader (``from_jax``)."""
from . import bert, dit, ernie, gpt, llama, qwen2_moe
from .bert import (BertConfig, BertForMaskedLM,
                   BertForSequenceClassification, BertModel)
from .dit import AutoencoderKL, DiT, DiTConfig, DiTWithDiffusion
from .ernie import Ernie45Config, Ernie45ForCausalLM, Ernie45ForCausalLMPipe
from .gpt import GPTConfig, GPTForCausalLM, GPTModel, GPTPretrainingCriterion
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel,
                    LlamaPretrainingCriterion)
from .qwen2_moe import Qwen2MoeConfig, Qwen2MoeForCausalLM
