"""Normalization ops (RMSNorm), computed in float32 for stability.
Counterpart of qwen3_tts_tpu/ops/norms.py."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis. Upcasts to f32, returns x.dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.reciprocal(torch.sqrt(var + eps))
    return (y * weight.float()).to(x.dtype)
