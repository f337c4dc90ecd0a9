"""Shared Qwen3-style decoder core for the talker and predictor.
Counterpart of qwen3_tts_tpu/models/transformer.py.

Parameters are dicts of stacked per-layer tensors in the JAX package's
layouts ([L, in, out] weights, qkv and gate/up fused along the output
axis).  Architecture: pre-RMSNorm, GQA with per-head q/k RMSNorm, rotary
tables supplied by the caller, SwiGLU MLP.  The KV cache is a stacked
[L, B, Hkv, C, Dh] pair with a static capacity C, UPDATED IN PLACE; prompt
padding is handled by the attention masks.  Attention runs through the
port's kernels (kernels/flash_prefill, kernels/flash_decode): the CUDA
kernels for tensors on the card, their plain versions on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..kernels.flash_decode import flash_gqa_decode_stacked
from ..kernels.flash_prefill import flash_gqa_prefill_stacked
from ..ops.attention import update_cache
from ..ops.norms import rms_norm
from ..ops.quant import matmul
from ..ops.rope import apply_rope


@dataclass
class KVCache:
    """Stacked KV cache.  k and v are written in place by
    `decoder_forward`; write_idx (the next free slot, one value per lane,
    all equal on this path) is replaced by the advanced cursor."""

    k: torch.Tensor          # [L, B, Hkv, C, Dh]
    v: torch.Tensor          # [L, B, Hkv, C, Dh]
    write_idx: torch.Tensor  # [B] int32
    lengths: torch.Tensor    # [B] int32: true prompt lengths (masking)

    @property
    def capacity(self) -> int:
        return self.k.shape[3]


def init_kv_cache(cfg, batch: int, capacity: int, dtype,
                  device) -> KVCache:
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, capacity, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        write_idx=torch.zeros(batch, dtype=torch.int32, device=device),
        lengths=torch.zeros(batch, dtype=torch.int32, device=device))


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def normal(generator: torch.Generator, shape, scale: float,
           dtype: torch.dtype) -> torch.Tensor:
    """Seeded N(0, scale^2) drawn in f32 on the generator's device, then
    cast (as the JAX inits draw f32 and cast)."""
    return (torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) * scale).to(dtype)


def init_decoder_params(cfg, generator: torch.Generator) -> Dict[str, Any]:
    """Random decoder weights (development mode), with the shapes, scales
    and dtypes of the JAX init; the draws themselves differ."""
    dtype = dtype_of(cfg.dtype)
    dev = generator.device
    d, f, n = cfg.d_model, cfg.d_ff, cfg.n_layers
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s_attn = d ** -0.5

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    return {
        "layers": {
            "ln1": ones(n, d),
            "ln2": ones(n, d),
            "wqkv": normal(generator, (n, d, (h + 2 * hkv) * dh), s_attn,
                           dtype),
            "wo": normal(generator, (n, h * dh, d), (h * dh) ** -0.5, dtype),
            "q_norm": ones(n, dh),
            "k_norm": ones(n, dh),
            "w_gate_up": normal(generator, (n, d, 2 * f), s_attn, dtype),
            "w_down": normal(generator, (n, f, d), f ** -0.5, dtype),
        },
        "final_norm": ones(d),
    }


def decoder_forward(cfg, params: Dict[str, Any], x: torch.Tensor,
                    cos: torch.Tensor, sin: torch.Tensor, cache: KVCache,
                    prompt_cap: int) -> Tuple[torch.Tensor, KVCache]:
    """Run the decoder over S new tokens written at the cache cursor.

    x: [B, S, D]; cos/sin: [B, S, Dh] rotary tables of the new positions.
    S > 1 is a prefill: its rows attend slots [0, min(max(prompt_cap, S),
    C)).  S == 1 is a decode step over the live prefix.  All lanes share
    one cursor (write_idx[0]).  k/v of the new rows are written into the
    cache IN PLACE.  Returns (hidden [B, S, D] after the final norm, the
    same cache with write_idx advanced by S).
    """
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    layers = params["layers"]
    start = cache.write_idx
    write_at = start[:1].long()
    window = min(max(prompt_cap, s), cache.capacity)
    for layer in range(cfg.n_layers):
        hn = rms_norm(x, layers["ln1"][layer], cfg.rms_eps)
        qkv = matmul(hn, layers["wqkv"][layer])
        q = qkv[..., : h * dh].reshape(b, s, h, dh)
        kk = qkv[..., h * dh: (h + hkv) * dh].reshape(b, s, hkv, dh)
        vv = qkv[..., (h + hkv) * dh:].reshape(b, s, hkv, dh)
        if cfg.qk_norm:
            q = rms_norm(q, layers["q_norm"][layer], cfg.rms_eps)
            kk = rms_norm(kk, layers["k_norm"][layer], cfg.rms_eps)
        q = apply_rope(q, cos, sin).contiguous()
        kk = apply_rope(kk, cos, sin)
        update_cache(cache.k[layer], kk, write_at)
        update_cache(cache.v[layer], vv, write_at)
        if s == 1:
            attn = flash_gqa_decode_stacked(
                q[:, 0], cache.k, cache.v, cache.lengths, start, layer,
                prompt_cap)
        else:
            attn = flash_gqa_prefill_stacked(
                q, cache.k, cache.v, cache.lengths, start, layer,
                prompt_cap, window)
        x = x + matmul(attn.reshape(b, s, h * dh), layers["wo"][layer])
        hn = rms_norm(x, layers["ln2"][layer], cfg.rms_eps)
        gu = matmul(hn, layers["w_gate_up"][layer])
        f_half = gu.shape[-1] // 2
        x = x + matmul(F.silu(gu[..., :f_half]) * gu[..., f_half:],
                       layers["w_down"][layer])
    hidden = rms_norm(x, params["final_norm"], cfg.rms_eps)
    cache.write_idx = cache.write_idx + s
    return hidden, cache
