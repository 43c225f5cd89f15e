"""The threefry stream on the card against the same on the CPU.

Marked ``cuda``; every test skips on a machine without a CUDA device.
This file imports neither JAX nor the reference package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_sampling.py

The words of a draw are integer arithmetic, so the bits, and the
uniforms made from them, must be equal on both devices.  The Gumbel
noise goes through ``log``, which the card rounds on its own: it is held
within 4 ulp of ``max(|g|, 1)``, and the drawn tokens must be equal
wherever the two largest perturbed logits of a row are more than 1e-5
apart.  ``filtered_probs`` within 1e-4 of each probability and the
log-probabilities within 1e-4 (sums over the vocabulary in another
order).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.common import prng
from paddle_tpu_torch.nn.generation import filtered_probs, sample_logits

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape", [(7,), (3, 256), (2, 128256)], ids=str)
def test_bits_and_uniforms_equal_the_cpu(dev, shape):
    key = prng.prng_key(1234)
    bits = prng.random_bits(key, shape, device=dev)
    assert torch.equal(bits.cpu(), prng.random_bits(key, shape))
    u = prng.uniform(key, shape, device=dev).cpu()
    assert torch.equal(u.view(torch.int32),
                       prng.uniform(key, shape).view(torch.int32))
    g = prng.gumbel(key, shape, device=dev).cpu()
    want = prng.gumbel(key, shape)
    ulp = torch.from_numpy(np.spacing(np.maximum(want.abs().numpy(), 1.0)))
    assert ((g - want).abs() <= 4 * ulp).all()


def _gap(logits, keys):
    """Each row's gap between its two largest perturbed logits (CPU)."""
    noise = prng._gumbel_from_bits(prng._bits_at(
        keys[:, 0:1], keys[:, 1:2],
        torch.arange(logits.shape[1], dtype=torch.int64)[None]))
    top2 = (logits + noise).topk(2, dim=-1).values
    return top2[:, 0] - top2[:, 1]


@pytest.mark.parametrize("kw", [dict(), dict(top_k=50, top_p=0.9,
                                              temperature=0.8)], ids=str)
def test_draws_equal_the_cpu(dev, kw):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(64, 128256, generator=gen) * 4
    key = prng.prng_key(9)
    rows = np.arange(64)
    tok_c, lp_c = sample_logits(x, key, strategy="sampling", row_ids=rows,
                                **kw)
    tok_g, lp_g = sample_logits(x.to(dev), key, strategy="sampling",
                                row_ids=rows, **kw)
    p_c = filtered_probs(x, strategy="sampling", **kw)
    p_g = filtered_probs(x.to(dev), strategy="sampling", **kw).cpu()
    # each probability relative to itself: the normaliser sums up to
    # 128256 terms in another order
    rel = ((p_c - p_g).abs() / p_c.clamp_min(1e-30)).max().item()
    assert rel <= 1e-4, rel
    filt = torch.log(p_c)            # the filtered logits, up to a shift
    keys = prng.fold_in_rows(key, torch.as_tensor(rows))
    clear = _gap(filt, keys) > 1e-5
    assert clear.float().mean() > 0.9, clear.float().mean()
    same = tok_c == tok_g.cpu()
    assert bool(same[clear].all()), (clear.sum(), same.sum())
    # log-probabilities: a log-sum of 128256 terms summed in another order
    lp_err = (lp_c - lp_g.cpu()).abs().max().item()
    assert lp_err <= 1e-4, lp_err
