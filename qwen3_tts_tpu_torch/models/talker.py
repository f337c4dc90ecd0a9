"""Talker: Qwen3 decoder over 2048-d prompt embeddings -> codebook-0 logits.
Counterpart of qwen3_tts_tpu/models/talker.py.

The input is raw embeddings (no token lookup); positions are M-RoPE
4-tuples with T=H=W=pos and channel=0; only the codec slice [0, 2160) of
the LM head (`codec_head`) is kept; both the logits and the final hidden
state of the sampled position are returned (the hidden feeds the
2048->1024 projection into the predictor).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..core.config import TalkerConfig
from ..ops.quant import head_matmul
from ..ops.rope import inv_freq_tensor, mrope_cos_sin, section_ids_tensor
from . import transformer
from .transformer import KVCache


def init_talker_params(cfg: TalkerConfig,
                       generator: torch.Generator) -> Dict[str, Any]:
    params = transformer.init_decoder_params(cfg, generator)
    params["codec_head"] = transformer.normal(
        generator, (cfg.n_codec_logits, cfg.d_model), cfg.d_model ** -0.5,
        transformer.dtype_of(cfg.dtype))
    return params


def _rope_tables(cfg: TalkerConfig, pos4: torch.Tensor):
    if sum(cfg.mrope_sections) != cfg.head_dim // 2:
        raise ValueError(
            f"mrope_sections {cfg.mrope_sections} must sum to head_dim/2 "
            f"= {cfg.head_dim // 2}")
    inv_freq = inv_freq_tensor(cfg.head_dim, cfg.rope_theta, pos4.device)
    sec = section_ids_tensor(tuple(cfg.mrope_sections), pos4.device)
    return mrope_cos_sin(pos4, inv_freq, sec)


def _pos4(pos: torch.Tensor) -> torch.Tensor:
    return torch.stack([pos, pos, pos, torch.zeros_like(pos)], dim=-1)


def talker_prefill(cfg: TalkerConfig, params, embeds: torch.Tensor,
                   lengths: torch.Tensor, cache: KVCache,
                   ) -> Tuple[torch.Tensor, torch.Tensor, KVCache]:
    """Prefill the padded prompt.

    embeds: [B, S_max, 2048]; lengths: [B] int32 true lengths (<= S_max).
    Returns (codec_logits [B, V_codec] f32, hidden [B, D] at each lane's
    last real token, cache advanced to write_idx = S_max, written in
    place, with lengths recorded).
    """
    b, s_max, _ = embeds.shape
    pos = torch.arange(s_max, device=embeds.device)[None, :].expand(b, s_max)
    cos, sin = _rope_tables(cfg, _pos4(pos))
    cache.lengths = lengths.to(torch.int32)
    hidden_all, cache = transformer.decoder_forward(
        cfg, params, embeds.to(transformer.dtype_of(cfg.dtype)), cos, sin,
        cache, prompt_cap=s_max)
    last = torch.clamp(lengths.long() - 1, 0, s_max - 1)
    hidden = hidden_all[torch.arange(b, device=embeds.device), last]
    return _codec_logits(params, hidden), hidden, cache


def talker_decode_step(cfg: TalkerConfig, params, embed: torch.Tensor,
                       pos: torch.Tensor, cache: KVCache, prompt_cap: int,
                       ) -> Tuple[torch.Tensor, torch.Tensor, KVCache]:
    """One autoregressive step on the feedback embedding (cache written in
    place).  embed: [B, 2048]; pos: [B] logical positions.
    Returns (codec_logits [B, V_codec] f32, hidden [B, D], cache)."""
    cos, sin = _rope_tables(cfg, _pos4(pos.long()[:, None]))
    hidden_all, cache = transformer.decoder_forward(
        cfg, params, embed[:, None, :].to(transformer.dtype_of(cfg.dtype)),
        cos, sin, cache, prompt_cap=prompt_cap)
    hidden = hidden_all[:, 0]
    return _codec_logits(params, hidden), hidden, cache


def _codec_logits(params, hidden: torch.Tensor) -> torch.Tensor:
    return head_matmul(hidden, params["codec_head"])


def init_talker_cache(cfg: TalkerConfig, batch: int, capacity: int,
                      device) -> KVCache:
    return transformer.init_kv_cache(cfg, batch, capacity,
                                     transformer.dtype_of(cfg.dtype), device)
