"""Speaker encoder: log-mel [frames, 128] -> 2048-d speaker embedding.
Counterpart of qwen3_tts_tpu/models/codec/speaker.py.

The mel front-end of ops.mel, a projection to d_model, residual conv1d
layers over time (GELU, tanh form), statistics pooling (attentive: learned
frame weights, ECAPA-style; or x-vector: uniform), a linear head to the
2048-d embedding, L2-normalized.  All in f32, plain PyTorch.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from ...core.config import SpeakerEncoderConfig
from ...ops.mel import log_mel
from ..transformer import dtype_of, normal


def init_speaker_params(cfg: SpeakerEncoderConfig,
                        generator: torch.Generator) -> Dict[str, Any]:
    """Random speaker-encoder weights (development mode): the JAX init's
    shapes, scales and dtypes, other draws."""
    if cfg.pooling not in ("attentive", "xvector"):
        raise ValueError(f"unknown speaker pooling {cfg.pooling!r} "
                         "(expected 'attentive' or 'xvector')")
    dtype = dtype_of(cfg.dtype)
    d = cfg.d_model

    def rnd(shape, scale):
        return normal(generator, shape, scale, dtype)

    params = {
        "in_proj": rnd((cfg.n_mels, d), cfg.n_mels ** -0.5),
        "convs": [{"w": rnd((d, d, 3), (3 * d) ** -0.5),
                   "b": torch.zeros((d,), dtype=dtype,
                                    device=generator.device)}
                  for _ in range(cfg.n_layers)],
        "head": rnd((2 * d, cfg.emb_dim), (2 * d) ** -0.5),
    }
    if cfg.pooling == "attentive":
        params["attn_w"] = rnd((d, d), d ** -0.5)
        params["attn_v"] = rnd((d,), d ** -0.5)
    return params


def speaker_embed_from_mel(cfg: SpeakerEncoderConfig, params,
                           mels: torch.Tensor) -> torch.Tensor:
    """mels [B, F, n_mels] -> [B, emb_dim] (L2-normalized).  F = 0 gives
    the embedding of zero statistics, as in the JAX package."""
    x = torch.matmul(mels.float(), params["in_proj"].float())
    x = x.transpose(1, 2)                                  # [B, D, F]
    if x.shape[-1]:
        for conv in params["convs"]:
            y = F.conv1d(F.pad(x, (1, 1)), conv["w"].float())
            x = x + F.gelu(y + conv["b"].float()[None, :, None],
                           approximate="tanh")
    x = x.transpose(1, 2)                                  # [B, F, D]
    if cfg.pooling == "attentive":
        scores = torch.matmul(torch.tanh(x @ params["attn_w"].float()),
                              params["attn_v"].float())
        w = torch.softmax(scores, dim=-1)[..., None]       # [B, F, 1]
    else:                                                  # "xvector"
        w = torch.full(x.shape[:2] + (1,), 1.0 / max(x.shape[1], 1),
                       dtype=torch.float32, device=x.device)
    mean = (w * x).sum(1)
    var = (w * (x - mean[:, None]) ** 2).sum(1)
    stats = torch.cat([mean, torch.sqrt(var + 1e-6)], dim=-1)
    emb = stats @ params["head"].float()
    return emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True) + 1e-9)


def speaker_embed(cfg: SpeakerEncoderConfig, params,
                  wav: torch.Tensor) -> torch.Tensor:
    """wav [B, T] (or [T]) f32 24 kHz -> [B, emb_dim]."""
    if wav.dim() == 1:
        wav = wav[None]
    mels = log_mel(wav, cfg.sample_rate, cfg.n_fft, cfg.hop_length,
                   cfg.n_mels, cfg.fmin, cfg.fmax)
    return speaker_embed_from_mel(cfg, params, mels)
