"""Grouped-query attention over a static-capacity KV cache.
Counterpart of qwen3_tts_tpu/ops/attention.py.

Cache layout is [B, n_kv, capacity, head_dim] per layer (stacked to
[L, B, n_kv, C, Dh] by the models).  Prompts are right-padded; validity is
an attention mask:

  slot c is attendable by the query at absolute slot q_slot iff
      c <= q_slot  (causal)
  and (c < length[b]          # real prompt tokens
       or c >= prompt_cap     # generated tokens
       or c == q_slot)        # self (keeps padded query rows finite)

These are the plain versions: the hand-written CUDA kernels in
`kernels/` compute the same function on the card.
"""

from __future__ import annotations

import torch

NEG_INF = -1e9


def history_mask(lengths: torch.Tensor, prompt_cap: int, start, s: int,
                 capacity: int) -> torch.Tensor:
    """Build the [B, S, C] boolean mask described above.

    lengths: [B] int true prompt lengths; start: [B] tensor or int,
    absolute slot of the first query; s: number of queries; capacity:
    number of cache slots scored.
    """
    dev = lengths.device
    c = torch.arange(capacity, device=dev)
    start = torch.as_tensor(start, device=dev).long().expand(lengths.shape)
    q = start[:, None] + torch.arange(s, device=dev)[None, :]        # [B, S]
    causal = c[None, None, :] <= q[:, :, None]                       # [B, S, C]
    in_prompt = c[None, None, :] < lengths.long()[:, None, None]
    generated = (c >= prompt_cap)[None, None, :]
    self_slot = c[None, None, :] == q[:, :, None]
    return causal & (in_prompt | generated | self_slot)


def gqa_attend(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Grouped-query attention in f32.

    q: [B, S, H, Dh]; k_cache/v_cache: [B, Hkv, C, Dh]; mask: [B, S, C].
    Returns [B, S, H, Dh] in q.dtype.
    """
    b, s, h, dh = q.shape
    hkv = k_cache.shape[1]
    g = h // hkv
    qf = q.reshape(b, s, hkv, g, dh).float()
    scores = torch.einsum("bskgd,bkcd->bkgsc", qf, k_cache.float()) \
        * dh ** -0.5
    scores = torch.where(mask[:, None, None, :, :], scores,
                         torch.full_like(scores, NEG_INF))
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgsc,bkcd->bskgd", weights, v_cache.float())
    return out.reshape(b, s, h, dh).to(q.dtype)


def update_cache(cache: torch.Tensor, new: torch.Tensor,
                 start: torch.Tensor) -> torch.Tensor:
    """Write `new` [B, S, Hkv, Dh] into cache [B, Hkv, C, Dh] IN PLACE at
    slots start..start+S-1, where `start` is a one-element int64 tensor
    (one cursor for every lane).  The index stays on the device, so the
    write needs no host sync.  Returns `cache`."""
    s = new.shape[1]
    slots = start.reshape(1) + torch.arange(s, device=cache.device)
    cache.index_copy_(2, slots, new.transpose(1, 2).to(cache.dtype))
    return cache
