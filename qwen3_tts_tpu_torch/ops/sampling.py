"""Sampling: temperature / top-k / top-p over the code_0 logits.
Counterpart of qwen3_tts_tpu/ops/sampling.py.

temperature <= 0 is greedy argmax (lowest index on ties).  Otherwise the
logits are sorted once (descending, stable), top-k keeps the first k ranks,
the softmax at temperature is taken over those, and top-p keeps the
smallest prefix whose cumulative probability reaches top_p, including the
token that crosses it (and always the top token).  The draw is an
inverse-CDF draw from a uniform of the caller's `torch.Generator`: the
same filtered distribution as the JAX package, not the same draws.
"""

from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1e9


def filtered_distribution(logits: torch.Tensor, temperature: float,
                          top_k: int, top_p: float
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The distribution sampling draws from, in sorted space.

    Returns (order [..., V] token ids by descending logit, probs [..., V]
    over those ranks, exactly 0 outside the kept set)."""
    logits = logits.float()
    v = logits.shape[-1]
    order = torch.argsort(-logits, dim=-1, stable=True)
    sorted_logits = torch.gather(logits, -1, order)
    ranks = torch.arange(v, device=logits.device)
    keep_k = ranks < top_k if top_k > 0 else torch.ones_like(ranks, dtype=torch.bool)
    temp = max(float(temperature), 1e-6)
    scaled = torch.where(keep_k, (sorted_logits - sorted_logits[..., :1]) / temp,
                         torch.full_like(sorted_logits, NEG_INF))
    probs = torch.softmax(scaled, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_p = ((cum - probs) < top_p) | (ranks == 0)
    final = torch.where(keep_p, scaled, torch.full_like(scaled, NEG_INF))
    probs = torch.softmax(final, dim=-1)
    return order, torch.where(keep_p & keep_k, probs, torch.zeros_like(probs))


def sample_logits(logits: torch.Tensor, generator: torch.Generator,
                  temperature: float, top_k: int, top_p: float
                  ) -> torch.Tensor:
    """Sample token ids from logits [..., V]. Returns int32 [...]."""
    if temperature <= 0.0:
        return torch.argmax(logits.float(), dim=-1).to(torch.int32)
    order, probs = filtered_distribution(logits, temperature, top_k, top_p)
    cdf = torch.cumsum(probs, dim=-1)
    u = torch.rand(probs.shape[:-1] + (1,), generator=generator,
                   device=probs.device) * cdf[..., -1:]
    # first rank whose cdf exceeds u; clamp guards u == total in f32
    rank = torch.searchsorted(cdf, u, right=True).clamp_(max=probs.shape[-1] - 1)
    # a zero-probability rank can only be hit through f32 ties at the edge
    # of the kept set: fall back to the highest kept rank
    n_kept = (probs > 0).sum(-1, keepdim=True)
    rank = torch.minimum(rank, n_kept - 1)
    return torch.gather(order, -1, rank)[..., 0].to(torch.int32)
