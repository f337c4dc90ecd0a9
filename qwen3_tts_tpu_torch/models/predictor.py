"""Predictor: expands each talker step into the 15 residual-VQ codes.
Counterpart of qwen3_tts_tpu/models/predictor.py.

Per frame: prefill [projected_hidden; emb1024(code_0)] at positions
[0, 1], then 14 single-token steps where step q greedily argmaxes the
logit window [(q-1)*2048, q*2048) and feeds emb1024(code_q) back at
position q + 1; the last codebook only needs its argmax.  The KV cache is
a fresh 17-slot buffer per frame.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..core.config import PredictorConfig
from ..ops.quant import head_matmul_slice
from ..ops.rope import inv_freq_tensor, rope_cos_sin
from . import transformer


def init_predictor_params(cfg: PredictorConfig,
                          generator: torch.Generator) -> Dict[str, Any]:
    params = transformer.init_decoder_params(cfg, generator)
    params["lm_head"] = transformer.normal(
        generator, (cfg.vocab_size, cfg.d_model), cfg.d_model ** -0.5,
        transformer.dtype_of(cfg.dtype))
    return params


def predict_frame(cfg: PredictorConfig, params, h1024: torch.Tensor,
                  code0: torch.Tensor, codec_tables_1024: torch.Tensor,
                  ) -> torch.Tensor:
    """Predict residual codes for one frame.

    h1024: [B, 1024] projected talker hidden; code0: [B] int32;
    codec_tables_1024: [16, R, 1024] pre-projected codebook tables.
    Returns codes [B, 16] int32 (codebook 0 = code0, then 15 residuals).
    """
    b = h1024.shape[0]
    dev = h1024.device
    dtype = transformer.dtype_of(cfg.dtype)
    inv_freq = inv_freq_tensor(cfg.head_dim, cfg.rope_theta, dev)
    capacity = 2 + cfg.n_residual_codebooks     # 17: prefill pair + 15
    cache = transformer.init_kv_cache(cfg, b, capacity, dtype, dev, params)

    emb0 = codec_tables_1024[0][code0.long()]
    x = torch.stack([h1024.float(), emb0.float()], dim=1).to(dtype)
    pos = torch.arange(2, device=dev)[None, :].expand(b, 2)
    cos, sin = rope_cos_sin(pos, inv_freq)
    hidden, cache = transformer.decoder_forward(cfg, params, x, cos, sin,
                                                cache, prompt_cap=0)
    w_logits = head_matmul_slice(hidden[:, -1], params["lm_head"], 0,
                                 cfg.codebook_size)
    codes = [code0.to(torch.int32)]
    for q in range(1, cfg.n_residual_codebooks):
        code_q = torch.argmax(w_logits, dim=-1)
        codes.append(code_q.to(torch.int32))
        emb_q = codec_tables_1024[q][code_q].to(dtype)
        cos, sin = rope_cos_sin(torch.full((b, 1), q + 1, device=dev),
                                inv_freq)
        hidden, cache = transformer.decoder_forward(
            cfg, params, emb_q[:, None, :], cos, sin, cache, prompt_cap=0)
        w_logits = head_matmul_slice(hidden[:, 0], params["lm_head"],
                                     q * cfg.codebook_size,
                                     cfg.codebook_size)
    codes.append(torch.argmax(w_logits, dim=-1).to(torch.int32))
    return torch.stack(codes, dim=1)
