"""Shared Qwen3-style decoder core for the talker and predictor.
Counterpart of qwen3_tts_tpu/models/transformer.py.

Parameters are dicts of stacked per-layer tensors in the JAX package's
layouts ([L, in, out] weights, qkv and gate/up fused along the output
axis).  Architecture: pre-RMSNorm, GQA with per-head q/k RMSNorm, rotary
tables supplied by the caller, SwiGLU MLP.  The KV cache is a stacked
[L, B, Hkv, C, Dh] pair with a static capacity C, UPDATED IN PLACE; prompt
padding is handled by the attention masks.  Attention runs through the
port's kernels (kernels/flash_prefill, kernels/flash_decode): the CUDA
kernels for tensors on the card, their plain versions on the CPU.  When
`params` carries the talker's packed weights of one talker-step mode under
"fused_<mode>" (runtime/generate.Generator adds them for
`TtsEngine(fused=True)`, in its `talker_mode`) and the talker-step kernel
takes the batch, a decode step (S == 1) is one call of
kernels/talker_step.talker_step_fused instead, followed by the final norm.

Weights: plain [in, out] tensors or the quantized dicts of ops.quant (int8
`{"q", "s"}`, int4 `{"q4", "s"}`), multiplied by ops.quant.matmul.
a8=True (the talker's prompt and suffix prefill, on by default through
`TtsEngine(a8_prefill=True)`, as the JAX package's QTTS_A8_PREFILL) runs
the S > 1 matmuls of int8 weights a8w8 (ops.quant.matmul_a8); decode
steps never do, and the predictor's S = 2 prefill passes a8=False, as in
the JAX package.

Cursors: every lane has its own write_idx.  uniform_cursor=True (one
request, or lanes that started together) writes all lanes at write_idx[0];
uniform_cursor=False (continuous batching) writes each lane at its own
cursor, and a decode step then attends through
kernels/flash_decode.flash_gqa_decode_append, which appends the row.

A rank's block of the weights on a mesh (parallel/mesh.shard_params,
which names the mesh under params["mesh"]) runs the row-parallel schedule
of the JAX parallel/tp.py here: each projection through
parallel/mesh.row_parallel (the rank's block of the input features, one
all-reduce over the model group), and the rank's contiguous block of the
q and kv heads through the same attention kernels at the rank-local head
counts; its KV cache holds those kv heads (`local_heads`).  wo's rows are
head-major, so the rank's attention output IS its block of wo's input.

full_prefix=True (the speculative-decoding verify forward,
models/talker.talker_verify_frames): S > 1 rows written mid-decode at
each lane's cursor attend the whole live prefix, prompt and generated
slots, through the prefill kernel with window = the cache's capacity and
the lanes' own starts; its per-lane causal predicate hides the slots past
each row, stale rows of an earlier request or a rejected draft included.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..kernels.flash_decode import (flash_gqa_decode_append,
                                    flash_gqa_decode_stacked)
from ..kernels.flash_prefill import flash_gqa_prefill_stacked
from ..kernels.talker_step import packed_mode
from ..kernels.talker_step import supported as talker_step_supported
from ..kernels.talker_step import talker_step_fused
from ..ops.attention import update_cache
from ..ops.norms import rms_norm
from ..ops.quant import matmul, matmul_a8, take
from ..ops.rope import apply_rope
from ..parallel.mesh import row_parallel


@dataclass
class KVCache:
    """Stacked KV cache.  k and v are written in place by
    `decoder_forward`; write_idx (the next free slot of each lane) is
    replaced by the advanced cursor."""

    k: torch.Tensor          # [L, B, Hkv, C, Dh]
    v: torch.Tensor          # [L, B, Hkv, C, Dh]
    write_idx: torch.Tensor  # [B] int32
    lengths: torch.Tensor    # [B] int32: true prompt lengths (masking)

    @property
    def capacity(self) -> int:
        return self.k.shape[3]


def local_heads(cfg, params) -> Tuple[int, int]:
    """(q heads, kv heads) that `params` attend over: all of cfg's, or a
    model group's share for a rank's block on a mesh (module docstring)."""
    mesh = params.get("mesh") if params is not None else None
    n = 1 if mesh is None else mesh.n_model
    if cfg.n_heads % n or cfg.n_kv_heads % n:
        raise ValueError(f"heads {cfg.n_heads} / kv heads {cfg.n_kv_heads} "
                         f"do not split over n_model={n}")
    return cfg.n_heads // n, cfg.n_kv_heads // n


def init_kv_cache(cfg, batch: int, capacity: int, dtype, device,
                  params=None) -> KVCache:
    """A zero cache; params: the weights it serves, whose kv heads it holds
    (local_heads; None: all of cfg's)."""
    shape = (cfg.n_layers, batch, local_heads(cfg, params)[1], capacity,
             cfg.head_dim)
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
                    prompt_cap: int, uniform_cursor: bool = True,
                    a8: bool = False, full_prefix: bool = False,
                    ) -> Tuple[torch.Tensor, KVCache]:
    """Run the decoder over S new tokens written at the cache cursor.

    x: [B, S, D]; cos/sin: [B, S, Dh] rotary tables of the new positions.
    S > 1 is a prefill: its rows attend slots [0, min(max(prompt_cap, S),
    C)), or [0, C) with full_prefix=True (a mid-decode forward: module
    docstring).  S == 1 is a decode step over the live prefix.  uniform_cursor:
    all lanes write at write_idx[0]; False: each lane at its own
    write_idx[b] (module docstring).  a8: S > 1 matmuls of int8 weights
    a8w8 (module docstring).  k/v of the new rows are written into the
    cache IN PLACE.  Returns (hidden [B, S, D] after the final norm, the
    same cache with write_idx advanced by S).  params may be a rank's
    block on a mesh (module docstring).
    """
    b, s, _ = x.shape
    mode = packed_mode(params)
    if (s == 1 and mode is not None
            and talker_step_supported(cfg, b, mode)):
        hidden1 = talker_step_fused(
            cfg, params["fused_" + mode], x[:, 0], cos[:, 0], sin[:, 0],
            cache.k, cache.v, cache.lengths, cache.write_idx, prompt_cap,
            uniform_cursor=uniform_cursor, mode=mode)
        hidden = rms_norm(hidden1[:, None, :], params["final_norm"],
                          cfg.rms_eps)
        cache.write_idx = cache.write_idx + 1
        return hidden, cache
    mesh = params.get("mesh")
    a8 = a8 and s > 1
    h, hkv = local_heads(cfg, params)
    dh = cfg.head_dim
    # this rank's q, k and v columns of qkv (all of them without a mesh)
    mi = 0 if mesh is None else mesh.model_index
    q0 = mi * h * dh
    k0 = (cfg.n_heads + mi * hkv) * dh
    v0 = (cfg.n_heads + cfg.n_kv_heads + mi * hkv) * dh
    layers = params["layers"]
    start = cache.write_idx
    write_at = start[:1] if uniform_cursor else start
    window = (cache.capacity if full_prefix
              else min(max(prompt_cap, s), cache.capacity))

    def mm(t, w, local=False):
        if mesh is not None:
            return row_parallel(mesh, t, w, a8, local)
        return matmul_a8(t, w) if a8 else matmul(t, w)

    for layer in range(cfg.n_layers):
        hn = rms_norm(x, layers["ln1"][layer], cfg.rms_eps)
        qkv = mm(hn, take(layers["wqkv"], layer))
        q = qkv[..., q0:q0 + h * dh].reshape(b, s, h, dh)
        kk = qkv[..., k0:k0 + hkv * dh].reshape(b, s, hkv, dh)
        vv = qkv[..., v0:v0 + hkv * dh].reshape(b, s, hkv, dh)
        if cfg.qk_norm:
            q = rms_norm(q, layers["q_norm"][layer], cfg.rms_eps)
            kk = rms_norm(kk, layers["k_norm"][layer], cfg.rms_eps)
        q = apply_rope(q, cos, sin).contiguous()
        kk = apply_rope(kk, cos, sin)
        if s == 1 and not uniform_cursor:
            # the kernel appends each lane's row at its own cursor
            attn = flash_gqa_decode_append(
                q[:, 0], cache.k, cache.v,
                kk[:, 0].to(cache.k.dtype).contiguous(),
                vv[:, 0].to(cache.v.dtype).contiguous(), cache.lengths,
                start, layer, prompt_cap)
        else:
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
        x = x + mm(attn.reshape(b, s, h * dh), take(layers["wo"], layer),
                   local=True)
        hn = rms_norm(x, layers["ln2"][layer], cfg.rms_eps)
        gu = mm(hn, take(layers["w_gate_up"], layer))
        f_half = gu.shape[-1] // 2
        x = x + mm(F.silu(gu[..., :f_half]) * gu[..., f_half:],
                   take(layers["w_down"], layer))
    hidden = rms_norm(x, params["final_norm"], cfg.rms_eps)
    cache.write_idx = cache.write_idx + s
    return hidden, cache
