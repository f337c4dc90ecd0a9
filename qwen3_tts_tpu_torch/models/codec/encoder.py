"""Codec encoder: 24 kHz waveform -> [frames, 16] residual-VQ codes.
Counterpart of qwen3_tts_tpu/models/codec/encoder.py.

A strided causal conv stack downsampling by prod(downsample_factors) ==
samples_per_frame (GELU, tanh form, after each conv), a projection to
d_model, then a 16-stage residual vector quantizer over the 2048-entry
codebooks.  Encoding is offline (voice cloning): no streaming state.
Convolutions, products and the quantizer's argmin are plain PyTorch
(conv1d, matmul), as they are plain XLA ops in the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from ...core.config import CodecEncoderConfig
from ..transformer import dtype_of, normal


def init_encoder_params(cfg: CodecEncoderConfig,
                        generator: torch.Generator) -> Dict[str, Any]:
    """Random encoder weights (development mode): the JAX init's shapes,
    scales and dtypes, other draws."""
    dtype = dtype_of(cfg.dtype)
    dev = generator.device

    def rnd(shape, scale):
        return normal(generator, shape, scale, dtype)

    chans = list(cfg.channels)
    stages = []
    for i, r in enumerate(cfg.downsample_factors):
        c_out = chans[min(i + 1, len(chans) - 1)]
        k = cfg.stage_kernel_mult * r
        stages.append({"w": rnd((c_out, chans[i], k),
                                (chans[i] * k) ** -0.5),
                       "b": torch.zeros((c_out,), dtype=dtype, device=dev)})
    return {
        "in_conv": {"w": rnd((chans[0], 1, cfg.conv_kernel),
                             cfg.conv_kernel ** -0.5),
                    "b": torch.zeros((chans[0],), dtype=dtype, device=dev)},
        "stages": stages,
        "out_proj": rnd((chans[-1], cfg.d_model), chans[-1] ** -0.5),
        "codebooks": rnd((cfg.n_codebooks, cfg.codebook_size, cfg.d_model),
                         1.0),
    }


def samples_per_frame(cfg: CodecEncoderConfig) -> int:
    spf = 1
    for r in cfg.downsample_factors:
        spf *= r
    return spf


def encode(cfg: CodecEncoderConfig, params, wav: torch.Tensor) -> torch.Tensor:
    """wav [B, T] f32 -> codes [B, T // prod(factors), 16] int32.  Trailing
    samples that do not fill a frame are dropped."""
    return rvq_encode(params["codebooks"], encode_latents(cfg, params, wav))


def encode_latents(cfg: CodecEncoderConfig, params,
                   wav: torch.Tensor) -> torch.Tensor:
    """The quantizer's input: wav [B, T] f32 -> z [B, T // prod(factors),
    d_model] f32 (the conv stack and the projection)."""
    spf = samples_per_frame(cfg)
    b, t = wav.shape
    n_frames = t // spf
    if n_frames == 0:
        return torch.zeros((b, 0, cfg.d_model), dtype=torch.float32,
                           device=wav.device)
    x = wav[:, : n_frames * spf].float()[:, None, :]       # [B, 1, T']
    x = F.gelu(_causal(x, params["in_conv"]["w"], params["in_conv"]["b"], 1),
               approximate="tanh")
    for p_stage, r in zip(params["stages"], cfg.downsample_factors):
        x = F.gelu(_causal(x, p_stage["w"], p_stage["b"], r),
                   approximate="tanh")
    return torch.matmul(x.transpose(1, 2), params["out_proj"].float())


def rvq_encode(codebooks: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Residual VQ: codebooks [Q, K, D], z [B, N, D] -> codes [B, N, Q]
    int32.  Each stage picks argmin |c|^2 - 2 r.c (the nearest entry; the
    JAX package's expression, kept as it is) and subtracts that entry from
    the residual."""
    residual = z.float()
    if residual.shape[1] == 0:
        return torch.zeros((*residual.shape[:2], codebooks.shape[0]),
                           dtype=torch.int32, device=z.device)
    codes = []
    for cb in codebooks:
        cbf = cb.float()
        c2 = (cbf ** 2).sum(-1)                            # [K]
        dots = torch.matmul(residual, cbf.t())             # [B, N, K]
        code = torch.argmin(c2 - 2.0 * dots, dim=-1)       # [B, N]
        residual = residual - cb[code]
        codes.append(code.to(torch.int32))
    return torch.stack(codes, dim=-1)


def _causal(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            stride: int) -> torch.Tensor:
    """Left-padded strided conv (cross-correlation, as XLA's OIH conv) so
    that frame n sees only samples <= n * stride.  The input is rounded to
    the weights' dtype and the products summed in f32, as the JAX
    package's conv with preferred_element_type f32."""
    k = w.shape[-1]
    pad = k - stride if k > stride else 0
    xx = F.pad(x, (pad, 0)).to(w.dtype).float()
    y = F.conv1d(xx, w.float(), stride=stride)
    return (y + b.float()[None, :, None]).to(x.dtype)
