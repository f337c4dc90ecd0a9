"""Weight matmuls and weight quantizers of the LMs.  Counterpart of
qwen3_tts_tpu/ops/quant.py.

The exact path (prefill, and the decode steps of `TtsEngine(fused=False)`)
multiplies the plain bf16/f32 weights.  The fused decode kernels quantize
those weights themselves, once, with the JAX package's math:

- `quantize_weight`: symmetric per-output-column int8 (the predictor
  kernel's weights, and per row for its lm-head);
- `quantize_head`: per-row int8 of an LM head (the chunk kernel's codec
  head and predictor lm-head);
- `quantize_int4_grouped`: symmetric int4 in groups of INT4_GROUP = 128
  along the contraction axis, scales stored as bf16 (the talker step's
  w4a8 weights; `qs4` of qwen3_tts_tpu/kernels/talker_step.py) or as f32
  (the chunk kernel's predictor; `_pack_w4` of
  qwen3_tts_tpu/kernels/chunk_step.py): the integers are the same.

Packed int4 layout of the port (`pack_int4` / `unpack_int4`).  A weight
[..., K, N] (x @ w) is stored OUTPUT-MAJOR as uint8 [..., N, K/2]: one
output column's K values are contiguous, so a GEMV reads each column as
one run of 16-byte vectors.  Inside each 4-byte word, covering K rows
8m..8m+7, byte j holds row 8m+j in its low nibble and row 8m+4+j in its
high nibble (two's complement).  `w & 0x0F0F0F0F` and
`(w >> 4) & 0x0F0F0F0F` then give four CONSECUTIVE K rows each, which
`__dp4a` multiplies with four consecutive int8 activations without any
shuffling.  The JAX package's half-split packing (row r with row r + K/2)
exists so that Mosaic can slice activations contiguously; it is not used
here (io/from_jax.talker_w4a8_from_jax converts it).
"""

from __future__ import annotations

from typing import Tuple

import torch

INT4_GROUP = 128


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w. x: [..., in], w: [in, out] -> [..., out] in x.dtype."""
    return torch.matmul(x, w)


def head_matmul(hidden: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """hidden [..., d] @ head.T -> [..., vocab] in f32."""
    return torch.matmul(hidden.float(), head.float().t())


def head_matmul_slice(hidden: torch.Tensor, head: torch.Tensor, start: int,
                      size: int) -> torch.Tensor:
    """hidden [..., d] @ head[start:start+size].T -> [..., size] in f32:
    reads only the needed head rows (one codebook window of the
    predictor's lm-head)."""
    return torch.matmul(hidden.float(), head[start:start + size].float().t())


def quantize_weight(w: torch.Tensor, axis: int = -2
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with one f32 scale per slice along `axis` (the
    contraction axis): returns (q int8 of w's shape, s f32 with `axis`
    removed)."""
    wf = w.float()
    amax = wf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale.squeeze(axis)


def quantize_head(head: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """LM head [vocab, d] -> (int8 [vocab, d], f32 per-row scales [vocab])."""
    return quantize_weight(head, axis=-1)


def quantize_int4_grouped(w: torch.Tensor, group: int = INT4_GROUP,
                          scale_dtype: torch.dtype = torch.bfloat16
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric grouped int4 of w [..., K, N] (contraction axis K).

    Per group of `group` K rows and output column: scale = max(amax,
    1e-8) / 7 in f32, q = clip(round_half_even(w / scale), -7, 7).
    Returns (q int8 [..., K, N] with values in [-7, 7], scales
    `scale_dtype` [..., K/group, N]): the quantization uses the f32
    scale, the product the stored one, as in the JAX package."""
    wf = w.float()
    *lead, k, n = wf.shape
    if k % group:
        raise ValueError(f"K={k} is not a multiple of the group {group}")
    wg = wf.reshape(*lead, k // group, group, n)
    amax = wg.abs().amax(dim=-2, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 7.0
    q = torch.clamp(torch.round(wg / scale), -7, 7).to(torch.int8)
    return q.reshape(*lead, k, n), scale.squeeze(-2).to(scale_dtype)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int4 values q [..., K, N] (int8 in [-8, 7], K % 8 == 0) -> the
    port's packed uint8 [..., N, K/2] (layout in the module docstring)."""
    *lead, k, n = q.shape
    if k % 8:
        raise ValueError(f"K={k} is not a multiple of 8")
    nib = q.transpose(-1, -2).to(torch.int16) & 0xF        # [..., N, K]
    nib = nib.reshape(*lead, n, k // 8, 2, 4)
    packed = nib[..., 0, :] | (nib[..., 1, :] << 4)        # [..., N, K/8, 4]
    return packed.reshape(*lead, n, k // 2).to(torch.uint8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """The inverse of `pack_int4`: uint8 [..., N, K/2] -> int8 [..., K, N]."""
    *lead, n, k2 = packed.shape
    p = packed.to(torch.int16).reshape(*lead, n, k2 // 4, 1, 4)
    nib = torch.cat([p & 0xF, (p >> 4) & 0xF], dim=-2)     # [..., N, K/8, 2, 4]
    vals = (nib ^ 8) - 8                                   # sign-extend
    return vals.reshape(*lead, n, 2 * k2).transpose(-1, -2).to(torch.int8)
