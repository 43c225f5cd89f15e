"""Token selection for the serving path (subset of
``paddle_tpu/nn/generation.py``): greedy decoding only.  Sampling with
top-k/top-p/temperature waits for a later slice."""
from __future__ import annotations

import torch

__all__ = ["sample_logits"]


def sample_logits(logits: torch.Tensor, *,
                  strategy: str = "greedy_search"):
    """logits [B, V] -> (token [B] int32, logprob [B] f32).

    Greedy takes the arg max; ties go to the first index, as
    ``jnp.argmax`` does in the reference."""
    if strategy != "greedy_search":
        raise NotImplementedError(
            f"decode strategy {strategy!r} is not ported yet (ROADMAP "
            f"'Port: remaining modules', sampling); only 'greedy_search' "
            f"runs")
    tok = torch.argmax(logits, dim=-1)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return tok.to(torch.int32), logp.gather(-1, tok[:, None])[:, 0]
