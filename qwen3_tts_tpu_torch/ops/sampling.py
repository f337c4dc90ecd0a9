"""Sampling: temperature / top-k / top-p over the code_0 logits.
Counterpart of qwen3_tts_tpu/ops/sampling.py.

temperature <= 0 is greedy argmax (lowest index on ties).  Otherwise the
logits are sorted once (descending, stable), top-k keeps the first k ranks,
the softmax at temperature is taken over those, and top-p keeps the
smallest prefix whose cumulative probability reaches top_p, including the
token that crosses it (and always the top token).  The draw is an
inverse-CDF draw from a uniform of the caller's `torch.Generator`: the
same filtered distribution as the JAX package, not the same draws.

`sample_threshold` is the chunk kernel's sampler (`_sample_inkernel` of
qwen3_tts_tpu/kernels/chunk_step.py) in plain PyTorch: no sort, thresholds
found by bisection, the uniform given by the caller.  It is the plain
version of the sampler inside csrc/chunk_step.cu.
"""

from __future__ import annotations

from typing import Optional, Tuple

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
                  temperature: float, top_k: int, top_p: float,
                  rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Sample token ids from logits [..., V]. Returns int32 [...].
    rows=(lo, total): logits [B, V] are rows [lo, lo + B) of a batch of
    `total` (one data rank's lanes, parallel/): the whole batch's uniforms
    are drawn and these rows kept, so each lane draws what it would in
    the whole batch."""
    if temperature <= 0.0:
        return torch.argmax(logits.float(), dim=-1).to(torch.int32)
    order, probs = filtered_distribution(logits, temperature, top_k, top_p)
    cdf = torch.cumsum(probs, dim=-1)
    if rows is None:
        u = torch.rand(probs.shape[:-1] + (1,), generator=generator,
                       device=probs.device)
    else:
        lo, total = rows
        u = torch.rand((total, 1), generator=generator,
                       device=probs.device)[lo:lo + probs.shape[0]]
    u = u * cdf[..., -1:]
    # first rank whose cdf exceeds u; clamp guards u == total in f32
    rank = torch.searchsorted(cdf, u, right=True).clamp_(max=probs.shape[-1] - 1)
    # a zero-probability rank can only be hit through f32 ties at the edge
    # of the kept set: fall back to the highest kept rank
    n_kept = (probs > 0).sum(-1, keepdim=True)
    rank = torch.minimum(rank, n_kept - 1)
    return torch.gather(order, -1, rank)[..., 0].to(torch.int32)


def sample_threshold(logits: torch.Tensor, u: torch.Tensor,
                     temperature: float, top_k: int, top_p: float
                     ) -> torch.Tensor:
    """Codes [B] int32 from logits [B, V] f32 and uniforms u [B] in [0, 1).

    temperature <= 0: the argmax, lowest index on ties.  Otherwise, all in
    f32: 24 bisection steps for the k-th largest logit (lo from -1e5, hi
    the max; kept: lg >= lo, or everything when top_k <= 0), the softmax
    of (lg - max) / max(temperature, 1e-6) over the kept set, 24 bisection
    steps for the nucleus threshold q (kept: p > q, lo from 0, hi the
    largest p), then 12 bisection steps on the column index for the first
    column whose prefix sum of kept p exceeds u * total."""
    lg = logits.float()
    b, v = lg.shape
    m = lg.max(dim=1, keepdim=True).values
    col = torch.arange(v, device=lg.device)[None, :]
    if temperature <= 0.0:
        return torch.where(lg >= m, col, v).min(dim=1).values.to(torch.int32)
    f32 = dict(dtype=torch.float32, device=lg.device)
    lo, hi = torch.full((b, 1), -1e5, **f32), m
    top_kf = torch.tensor(float(top_k), **f32)
    for _ in range(24):
        mid = 0.5 * (lo + hi)
        ge = (lg >= mid).float().sum(dim=1, keepdim=True) >= top_kf
        lo, hi = torch.where(ge, mid, lo), torch.where(ge, hi, mid)
    keep_k = (lg >= lo) | (top_kf <= 0)
    temp_c = torch.tensor(max(float(temperature), 1e-6), **f32)
    e = torch.exp(torch.where(keep_k, (lg - m) / temp_c,
                              torch.tensor(-1e30, **f32)))
    p = e / e.sum(dim=1, keepdim=True)
    plo, phi = torch.zeros((b, 1), **f32), p.max(dim=1, keepdim=True).values
    top_pf = torch.tensor(float(top_p), **f32)
    for _ in range(24):
        qmid = 0.5 * (plo + phi)
        ge = torch.where(p > qmid, p, 0.0).sum(dim=1, keepdim=True) >= top_pf
        plo, phi = torch.where(ge, qmid, plo), torch.where(ge, phi, qmid)
    final = torch.where(keep_k & (p > plo), p, 0.0)
    target = u.float().reshape(b, 1) * final.sum(dim=1, keepdim=True)
    ilo = torch.zeros((b, 1), dtype=torch.int64, device=lg.device)
    ihi = torch.full((b, 1), v - 1, dtype=torch.int64, device=lg.device)
    for _ in range(12):                                # 2^12 > V
        imid = (ilo + ihi) // 2
        gt = torch.where(col <= imid, final, 0.0).sum(dim=1,
                                                      keepdim=True) > target
        ihi, ilo = torch.where(gt, imid, ihi), torch.where(gt, ilo, imid + 1)
    return ihi[:, 0].to(torch.int32)
