"""Diffusion Transformer and a KL autoencoder (counterpart of
``paddle_tpu/models/dit.py``).

``DiT``: a patchify ``Conv2D``, sinusoidal timestep features (f32) and a
label table with classifier-free-guidance dropout, adaLN-Zero
transformer blocks whose bidirectional attention goes through the flash
kernels (``F.scaled_dot_product_attention``), and an unpatchify head.
``DiTWithDiffusion`` adds the DDPM epsilon objective on a linear beta
schedule: timesteps, noise and the label drop are drawn from the
trainer's generator (``ops/random.py``).  ``AutoencoderKL`` is the
conv + GroupNorm encoder to a diagonal-Gaussian latent and its mirrored
decoder, with the reconstruction + KL loss.

Dtypes follow the reference's promotions: under amp O2 the timestep
features stay f32, so the conditioning vector, the adaLN modulations
and the residual stream after the first block are f32, and the blocks'
products and attention run in f32 (an f32 input to a bf16 ``Linear``
computes in f32, ``nn/common.py``); the patchify convolution takes the
weight's dtype.

The module trees carry the reference's parameter names
(``dit.blocks.N.qkv.weight``, ``enc.1.conv1.weight`` ...), so a
reference ``raw_state_dict()`` loads 1:1 (``models/from_jax.py``).
Parameters are drawn on ``device`` (default: the GPU) from a seeded
``torch.Generator``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..nn import functional as F
from ..nn.common import Embedding, Init, Linear
from ..nn.conv import Conv2D
from ..nn.initializer import Constant, Normal, XavierUniform
from ..nn.norm import GroupNorm, LayerNorm
from ..ops import random as _random

__all__ = ["DiTConfig", "DiT", "DiTWithDiffusion", "AutoencoderKL",
           "ResnetBlock", "TimestepEmbedder", "LabelEmbedder", "DiTBlock",
           "FinalLayer", "dit_tiny_config", "dit_s2_config"]


@dataclass
class DiTConfig:
    input_size: int = 32           # latent H = W
    patch_size: int = 2
    in_channels: int = 4
    hidden_size: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    class_dropout_prob: float = 0.1
    num_train_timesteps: int = 1000
    initializer_range: float = 0.02


def dit_s2_config() -> DiTConfig:
    """DiT-S/2 shape."""
    return DiTConfig()


def dit_tiny_config() -> DiTConfig:
    return DiTConfig(input_size=8, patch_size=2, in_channels=4,
                     hidden_size=64, depth=2, num_heads=4, num_classes=10,
                     num_train_timesteps=100)


class _SiLU(nn.Module):
    def forward(self, x):
        return F.silu(x)


def timestep_features(t, dim: int) -> torch.Tensor:
    """Sinusoidal features ``[B, dim]`` of timesteps ``t`` ``[B]``, f32:
    ``cat(cos(t f), sin(t f))`` with ``f_i = exp(-ln(1e4) i / (dim /
    2))``."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class TimestepEmbedder(nn.Module):
    """Sinusoidal timestep features (f32) -> 2-layer SiLU MLP."""

    def __init__(self, hidden_size: int, freq_dim: int = 256, *,
                 init: Init):
        super().__init__()
        self.freq_dim = freq_dim
        w = Normal(0.0, 0.02)
        self.mlp = nn.Sequential(
            Linear(freq_dim, hidden_size, weight_attr=w, **init.kw), _SiLU(),
            Linear(hidden_size, hidden_size, weight_attr=w, **init.kw))

    def forward(self, t):
        return self.mlp(timestep_features(t, self.freq_dim))


class LabelEmbedder(nn.Module):
    """Class-label table with classifier-free-guidance dropout: while
    training, each label is replaced by the extra ``num_classes`` row
    with probability ``dropout_prob`` (drawn from the guarded
    generator)."""

    def __init__(self, num_classes: int, hidden_size: int,
                 dropout_prob: float, *, init: Init):
        super().__init__()
        self.num_classes = num_classes
        self.dropout_prob = dropout_prob
        self.table = Embedding(num_classes + 1, hidden_size,
                               weight_attr=Normal(0.0, 0.02), **init.kw)

    def forward(self, labels, train: bool = True):
        if train and self.dropout_prob > 0:
            drop = _random.rand([labels.shape[0]],
                                device=labels.device) < self.dropout_prob
            labels = torch.where(drop, torch.full_like(
                labels, self.num_classes), labels)
        return self.table(labels)


class DiTBlock(nn.Module):
    """adaLN-Zero transformer block: the conditioning vector gives
    shift / scale / gate for the attention and MLP branches; the gates
    start at zero (an identity block at initialisation)."""

    def __init__(self, c: DiTConfig, *, init: Init):
        super().__init__()
        h = c.hidden_size
        self.num_heads = c.num_heads
        place = dict(device=init.device, dtype=init.dtype)
        self.norm1 = LayerNorm(h, epsilon=1e-6, weight_attr=False,
                               bias_attr=False, **place)
        self.qkv = Linear(h, 3 * h, weight_attr=XavierUniform(), **init.kw)
        self.proj = Linear(h, h, weight_attr=XavierUniform(), **init.kw)
        self.norm2 = LayerNorm(h, epsilon=1e-6, weight_attr=False,
                               bias_attr=False, **place)
        mh = int(h * c.mlp_ratio)
        self.fc1 = Linear(h, mh, weight_attr=XavierUniform(), **init.kw)
        self.fc2 = Linear(mh, h, weight_attr=XavierUniform(), **init.kw)
        self.adaLN = Linear(h, 6 * h, weight_attr=Constant(0.0), **init.kw)

    def forward(self, x, cond):
        b, n, h = x.shape
        mods = self.adaLN(F.silu(cond)).chunk(6, dim=-1)
        shift_a, scale_a, gate_a, shift_m, scale_m, gate_m = [
            m[:, None] for m in mods]
        xa = self.norm1(x) * (1 + scale_a) + shift_a
        qkv = self.qkv(xa).reshape(b, n, 3, self.num_heads,
                                   h // self.num_heads)
        q, k, v = qkv.unbind(dim=2)
        attn = F.scaled_dot_product_attention(q, k, v, is_causal=False)
        x = x + gate_a * self.proj(attn.reshape(b, n, h))
        xm = self.norm2(x) * (1 + scale_m) + shift_m
        return x + gate_m * self.fc2(F.gelu(self.fc1(xm), approximate=True))


class FinalLayer(nn.Module):
    def __init__(self, c: DiTConfig, out_channels: int, *, init: Init):
        super().__init__()
        h = c.hidden_size
        self.norm = LayerNorm(h, epsilon=1e-6, weight_attr=False,
                              bias_attr=False, device=init.device,
                              dtype=init.dtype)
        self.adaLN = Linear(h, 2 * h, weight_attr=Constant(0.0), **init.kw)
        self.linear = Linear(h, c.patch_size * c.patch_size * out_channels,
                             weight_attr=Constant(0.0), **init.kw)

    def forward(self, x, cond):
        shift, scale = [m[:, None] for m in
                        self.adaLN(F.silu(cond)).chunk(2, dim=-1)]
        return self.linear(self.norm(x) * (1 + scale) + shift)


class DiT(nn.Module):
    """Diffusion Transformer: the epsilon-prediction network over
    latents ``[B, C, H, W]``."""

    # the reference annotates it for tensor parallelism (dist_spec);
    # fleet.distributed_model refuses it at mp > 1 (not split here)
    _mp_annotated = True

    def __init__(self, config: DiTConfig, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 init: Optional[Init] = None):
        super().__init__()
        c = self.config = config
        init = init or Init.on(device, dtype, generator)
        self.out_channels = c.in_channels
        self.x_embed = Conv2D(c.in_channels, c.hidden_size,
                              kernel_size=c.patch_size, stride=c.patch_size,
                              **init.kw)
        self.t_embed = TimestepEmbedder(c.hidden_size, init=init)
        self.y_embed = LabelEmbedder(c.num_classes, c.hidden_size,
                                     c.class_dropout_prob, init=init)
        n_patches = (c.input_size // c.patch_size) ** 2
        self.pos_embed = nn.Parameter(Normal(0.0, 0.02)(
            [1, n_patches, c.hidden_size], **init.kw))
        self.blocks = nn.ModuleList([DiTBlock(c, init=init)
                                     for _ in range(c.depth)])
        self.final = FinalLayer(c, self.out_channels, init=init)

    def forward(self, x, t, y, train: bool = True):
        """x ``[B, C, H, W]`` latents, t ``[B]`` timesteps, y ``[B]``
        labels -> the epsilon prediction ``[B, C, H, W]``."""
        c = self.config
        b = x.shape[0]
        x = self.x_embed(x)                         # [B, hid, H/p, W/p]
        hp = x.shape[2]
        x = x.reshape(b, c.hidden_size, hp * hp).transpose(1, 2)
        x = x + self.pos_embed
        cond = self.t_embed(t) + self.y_embed(y, train=train)
        for blk in self.blocks:
            x = blk(x, cond)
        x = self.final(x, cond)                     # [B, N, p*p*C]
        p = c.patch_size
        x = x.reshape(b, hp, hp, p, p, self.out_channels)
        x = x.permute(0, 5, 1, 3, 2, 4)             # B C h p w p
        return x.reshape(b, self.out_channels, hp * p, hp * p)


class DiTWithDiffusion(nn.Module):
    """DiT with the DDPM epsilon objective: one call is the training
    loss of a batch of (latents, labels), its timesteps and noise drawn
    from the guarded generator on the latents' device."""

    # the reference annotates it for tensor parallelism (dist_spec);
    # fleet.distributed_model refuses it at mp > 1 (not split here)
    _mp_annotated = True

    def __init__(self, config: DiTConfig, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        init = Init.on(device, dtype, generator)
        self.dit = DiT(config, init=init)
        self.config = config
        betas = np.linspace(1e-4, 2e-2, config.num_train_timesteps,
                            dtype=np.float64)
        abar = np.cumprod(1.0 - betas).astype(np.float32)
        dev = init.device
        self.register_buffer("sqrt_abar", torch.from_numpy(
            np.sqrt(abar)).to(dev), persistent=False)
        self.register_buffer("sqrt_1m_abar", torch.from_numpy(
            np.sqrt(1 - abar)).to(dev), persistent=False)

    def diffusion_loss(self, x, y, t, eps):
        """The objective at given timesteps ``t`` ``[B]`` and noise
        ``eps`` (x's shape): ``mse(dit(sqrt(abar_t) x + sqrt(1 - abar_t)
        eps, t, y), eps)``."""
        b = x.shape[0]
        idx = t.long()
        sa = self.sqrt_abar[idx].reshape(b, 1, 1, 1)
        s1 = self.sqrt_1m_abar[idx].reshape(b, 1, 1, 1)
        pred = self.dit(x * sa + eps * s1, t, y, train=self.training)
        return F.mse_loss(pred, eps)

    def forward(self, x, y):
        b = x.shape[0]
        t = _random.randint(0, self.config.num_train_timesteps, [b],
                            device=x.device)
        eps = _random.randn(x.shape, dtype=x.dtype, device=x.device)
        return self.diffusion_loss(x, y, t, eps)


# ---------------------------------------------------------------------------
# AutoencoderKL-style VAE (an SD3 component): conv + GroupNorm
# ---------------------------------------------------------------------------

class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int = 8, *,
                 init: Init):
        super().__init__()
        kw, place = init.kw, dict(device=init.device, dtype=init.dtype)
        self.norm1 = GroupNorm(groups, cin, epsilon=1e-6, **place)
        self.conv1 = Conv2D(cin, cout, 3, padding=1, **kw)
        self.norm2 = GroupNorm(groups, cout, epsilon=1e-6, **place)
        self.conv2 = Conv2D(cout, cout, 3, padding=1, **kw)
        self.skip = Conv2D(cin, cout, 1, **kw) if cin != cout else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        return (self.skip(x) if self.skip is not None else x) + h


class _Upsample2x(nn.Module):
    def forward(self, x):
        return F.interpolate(x, scale_factor=2.0, mode="nearest")


class AutoencoderKL(nn.Module):
    """Compact SD-style KL autoencoder: a conv / GroupNorm encoder to a
    diagonal-Gaussian latent (one stride-2 step), a mirrored decoder;
    ``training_loss`` is the reconstruction MSE + ``kl_weight`` x KL.
    The latent sample's noise is drawn from the guarded generator."""

    def __init__(self, in_channels: int = 3, latent_channels: int = 4,
                 base: int = 32, groups: int = 8, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        p = Init.on(device, dtype, generator)
        kw, place = p.kw, dict(device=p.device, dtype=p.dtype)
        self.enc = nn.Sequential(
            Conv2D(in_channels, base, 3, padding=1, **kw),
            ResnetBlock(base, base, groups, init=p),
            Conv2D(base, base * 2, 3, stride=2, padding=1, **kw),   # /2
            ResnetBlock(base * 2, base * 2, groups, init=p),
            GroupNorm(groups, base * 2, epsilon=1e-6, **place))
        self.to_moments = Conv2D(base * 2, 2 * latent_channels, 1, **kw)
        self.dec_in = Conv2D(latent_channels, base * 2, 1, **kw)
        self.dec = nn.Sequential(
            ResnetBlock(base * 2, base * 2, groups, init=p),
            _Upsample2x(),
            Conv2D(base * 2, base, 3, padding=1, **kw),
            ResnetBlock(base, base, groups, init=p),
            GroupNorm(groups, base, epsilon=1e-6, **place))
        self.dec_out = Conv2D(base, in_channels, 3, padding=1, **kw)

    def encode(self, x):
        """(mean, logvar) of the latent, logvar clipped to [-30, 20]."""
        moments = self.to_moments(F.silu(self.enc(x)))
        mean, logvar = moments.chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z):
        return self.dec_out(F.silu(self.dec(self.dec_in(z))))

    def forward(self, x):
        mean, logvar = self.encode(x)
        z = mean + torch.exp(0.5 * logvar) * _random.randn(
            mean.shape, dtype=mean.dtype, device=mean.device)
        return self.decode(z), mean, logvar

    def training_loss(self, x, kl_weight: float = 1e-4):
        recon, mean, logvar = self(x)
        rec = F.mse_loss(recon, x)
        kl = 0.5 * torch.mean(torch.exp(logvar) + mean * mean - 1.0 - logvar)
        return rec + kl_weight * kl
