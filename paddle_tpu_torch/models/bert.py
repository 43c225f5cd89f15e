"""BERT family (counterpart of ``paddle_tpu/models/bert.py``):
``BertModel`` and its sequence-classification and masked-LM heads.

The encoder is ``nn/transformer.py``'s post-norm ``TransformerEncoder``:
attention through the flash kernels, with attention dropout inside
them while training, and each residual add fused into its LayerNorm
(the add+norm kernel's LayerNorm body on the card).  A ``[B, S]``
``attention_mask`` (1 = attend) becomes the additive ``[B, 1, 1, S]``
bias of 0 / -1e30 that the kernels broadcast over heads and query rows,
as the reference's does.

The module tree carries the reference's parameter names
(``bert.encoder.layers.N.self_attn.q_proj.weight`` ...), so a reference
``raw_state_dict()`` loads 1:1 (``models/from_jax.py``).  Parameters are
drawn on ``device`` (default: the GPU) from a seeded
``torch.Generator``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..nn import functional as F
from ..nn.common import Dropout, Init
from ..nn.transformer import TransformerEncoder, TransformerEncoderLayer

__all__ = ["BertConfig", "BertModel", "BertForSequenceClassification",
           "BertForMaskedLM", "bert_tiny_config"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0


def bert_tiny_config() -> BertConfig:
    return BertConfig(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                      num_attention_heads=4, intermediate_size=128,
                      max_position_embeddings=64,
                      hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0)


def padding_bias(attention_mask: torch.Tensor) -> torch.Tensor:
    """``[B, S]`` keep mask (1 = attend) -> the additive ``[B, 1, 1, S]``
    f32 bias: 0 where kept, -1e30 where padded."""
    m = attention_mask.float()
    return ((m - 1.0) * 1e30)[:, None, None, :]


class BertEmbeddings(nn.Module):
    def __init__(self, c: BertConfig, init: Init):
        super().__init__()
        std = c.initializer_range
        self.word_embeddings = init.embedding(c.vocab_size, c.hidden_size,
                                              std)
        self.position_embeddings = init.embedding(
            c.max_position_embeddings, c.hidden_size, std)
        self.token_type_embeddings = init.embedding(c.type_vocab_size,
                                                    c.hidden_size, std)
        self.layer_norm = init.layer_norm(c.hidden_size, c.layer_norm_eps)
        self.dropout = Dropout(c.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        b, s = input_ids.shape
        dev = input_ids.device
        if position_ids is None:
            position_ids = torch.arange(s, dtype=torch.int32, device=dev)
        if token_type_ids is None:
            token_type_ids = torch.zeros((b, s), dtype=torch.int32,
                                         device=dev)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(x))


class BertPooler(nn.Module):
    def __init__(self, c: BertConfig, init: Init):
        super().__init__()
        self.dense = init.linear(c.hidden_size, c.hidden_size,
                                 c.initializer_range, bias=True)

    def forward(self, x):
        return torch.tanh(self.dense(x[:, 0]))


class BertModel(nn.Module):
    """``forward(input_ids, ...) -> (sequence [B, S, H], pooled [B, H])``
    on ``device`` (default: the GPU), drawn from ``generator``."""

    def __init__(self, config: BertConfig, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 init: Optional[Init] = None):
        super().__init__()
        c = self.config = config
        init = init or Init.on(device, dtype, generator)
        self.embeddings = BertEmbeddings(c, init)
        enc_layer = TransformerEncoderLayer(
            c.hidden_size, c.num_attention_heads, c.intermediate_size,
            dropout=c.hidden_dropout_prob, activation=c.hidden_act,
            attn_dropout=c.attention_probs_dropout_prob,
            act_dropout=c.hidden_dropout_prob,
            layer_norm_eps=c.layer_norm_eps, **init.kw)
        self.encoder = TransformerEncoder(enc_layer, c.num_hidden_layers)
        self.pooler = BertPooler(c, init)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        """``attention_mask``: ``[B, S]`` with 1 = attend (the
        Paddle/HF BERT convention), turned into the additive bias."""
        bias = None if attention_mask is None else padding_bias(
            torch.as_tensor(attention_mask, device=input_ids.device))
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        x = self.encoder(x, src_mask=bias)
        return x, self.pooler(x)


class BertForSequenceClassification(nn.Module):
    def __init__(self, config: BertConfig, num_classes: int = 2, *,
                 device=None, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        init = Init.on(device, dtype, generator)
        self.bert = BertModel(config, init=init)
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.classifier = init.linear(config.hidden_size, num_classes,
                                      config.initializer_range, bias=True)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, labels=None):
        """Logits ``[B, num_classes]``, or with ``labels`` the mean
        cross-entropy."""
        _, pooled = self.bert(input_ids, token_type_ids, position_ids,
                              attention_mask)
        logits = self.classifier(self.dropout(pooled))
        if labels is not None:
            return F.cross_entropy(logits, labels)
        return logits


class BertForMaskedLM(nn.Module):
    """The masked-LM head: dense + GELU + LayerNorm, then the product
    with the word embeddings (tied, the BERT convention) plus
    ``decoder_bias``."""

    def __init__(self, config: BertConfig, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = config
        init = Init.on(device, dtype, generator)
        self.bert = BertModel(c, init=init)
        self.transform = init.linear(c.hidden_size, c.hidden_size,
                                     c.initializer_range, bias=True)
        self.layer_norm = init.layer_norm(c.hidden_size, c.layer_norm_eps)
        self.decoder_bias = nn.Parameter(torch.zeros(
            c.vocab_size, device=init.device, dtype=init.dtype))

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, labels=None, ignore_index=-100):
        """Logits ``[B, S, V]``, or with ``labels`` the mean
        cross-entropy over the labels that are not ``ignore_index``."""
        seq, _ = self.bert(input_ids, token_type_ids, position_ids,
                           attention_mask)
        h = self.layer_norm(F.gelu(self.transform(seq)))
        logits = h @ self.bert.embeddings.word_embeddings.weight.t() \
            + self.decoder_bias
        if labels is not None:
            return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                   labels.reshape(-1),
                                   ignore_index=ignore_index)
        return logits
