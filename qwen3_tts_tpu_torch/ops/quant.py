"""Weight matmuls and weight quantizers of the LMs.  Counterpart of
qwen3_tts_tpu/ops/quant.py.

A weight is a plain tensor [..., in, out] (bf16/f32) or a quantized dict,
as in the JAX package (`is_quantized`, `is_int4`):

- int8 `{"q": int8 [..., in, out], "s": f32 [..., out]}`, symmetric per
  output column (`quantize_weight`, `quantize_decoder_layers`; an LM head
  [vocab, d] per row, `quantize_head`);
- int4 `{"q4": uint8 [..., out, in/2], "s": f32 [..., out, in/G]}`,
  symmetric in groups of G input rows (`quantize_weight_int4`,
  `quantize_decoder_layers_int4`), in the port's own OUTPUT-MAJOR packing
  (`pack_int4` below; io/from_jax.int4_from_jax converts the JAX
  package's interleaved `q4 [..., in/2, out]`, byte i = rows 2i and 2i+1,
  and its `s [..., in/G, out]`).

`matmul` multiplies any of them with the JAX package's numerics: plain
weights as they are; int8 as `(x @ x.dtype(q)) * s` in x's dtype; int4
through kernels/int4_matmul (f32 out, then x's dtype).  `matmul_a8` is the
a8w8 prompt-prefill matmul of int8 weights: activations quantized per row
(absmax / 127), an int8 x int8 -> int32 product (`torch._int_mm`: the JAX
package computes it in XLA, outside any Pallas kernel), times both scales.
`head_matmul` / `head_matmul_slice` take a plain or int8 head.

The fused decode kernels quantize their weights once, from plain or int8
weights (an int8 weight is dequantized in f32, q * s, first), with the
JAX package's math:

- `quantize_weight`: the predictor kernel's int8 weights (and per row for
  its lm-head), the talker step's int8 / w8a8 modes;
- `quantize_head`: the chunk kernel's codec head and predictor lm-head;
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

from typing import Any, Dict, Tuple

import torch

INT4_GROUP = 128


QTensor = Dict[str, torch.Tensor]


def is_quantized(w) -> bool:
    return isinstance(w, dict) and ("q" in w or "q4" in w) and "s" in w


def is_int4(w) -> bool:
    return isinstance(w, dict) and "q4" in w


def take(w, i: int):
    """Layer i of a stacked weight: a plain tensor or a quantized dict."""
    return {k: v[i] for k, v in w.items()} if isinstance(w, dict) else w[i]


def dequantize(w) -> torch.Tensor:
    """f32 values of a plain or int8 weight [..., in, out]: q * s, the f32
    product the JAX preps start from."""
    if not is_quantized(w):
        return w.float()
    if is_int4(w):
        raise ValueError("dequantize takes plain or int8 weights")
    return w["q"].float() * w["s"].float().unsqueeze(-2)


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for plain or quantized weights. x: [..., in] -> [..., out] in
    x.dtype."""
    if not is_quantized(w):
        return torch.matmul(x, w)
    if is_int4(w):
        from ..kernels.int4_matmul import matmul_int4
        return matmul_int4(x, w).to(x.dtype)
    y = torch.matmul(x, w["q"].to(x.dtype))
    return y * w["s"].to(y.dtype)


def _int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] @ int8 [K, N] -> exact int32 [M, N] (torch._int_mm; on
    the card it takes M > 16 and K, N multiples of 8, so fewer rows are
    padded with zero rows, whose products are dropped)."""
    m, k = a.shape
    n = b.shape[1]
    if a.device.type != "cuda":
        return torch._int_mm(a, b)
    if k % 8 or n % 8:
        raise ValueError(f"matmul_a8 on the card needs K {k} and N {n} "
                         "multiples of 8")
    pad = max(32, -(-m // 8) * 8) - m
    if pad:
        a = torch.cat([a, a.new_zeros(pad, k)])
    return torch._int_mm(a, b)[:m]


def matmul_a8(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w with int8 activations x int8 weights (a8w8), JAX
    `ops.quant.matmul_a8`: sx = max(amax_row, 1e-8) / 127, xq =
    round_half_even(x / sx), an exact int32 product, then
    (f32(acc) * sx * s) in x.dtype.  Plain and int4 weights take
    `matmul`."""
    if not is_quantized(w) or is_int4(w):
        return matmul(x, w)
    xf = x.float()
    sx = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-8) / 127.0
    xq = torch.round(xf / sx).to(torch.int8)
    lead, k = xq.shape[:-1], xq.shape[-1]
    y = _int8_mm(xq.reshape(-1, k).contiguous(), w["q"])
    y = y.reshape(*lead, -1)
    return (y.float() * sx * w["s"].float()).to(x.dtype)


def head_matmul(hidden: torch.Tensor, head) -> torch.Tensor:
    """hidden [..., d] @ head.T -> [..., vocab] in f32; an int8 head
    multiplies bf16(hidden) by its integers, then the row scales."""
    if not is_quantized(head):
        return torch.matmul(hidden.float(), head.float().t())
    y = torch.matmul(hidden.to(torch.bfloat16).float(), head["q"].float().t())
    return y * head["s"].float()


def head_matmul_slice(hidden: torch.Tensor, head, start: int,
                      size: int) -> torch.Tensor:
    """hidden [..., d] @ head[start:start+size].T -> [..., size] in f32:
    reads only the needed head rows (one codebook window of the
    predictor's lm-head)."""
    if not is_quantized(head):
        return torch.matmul(hidden.float(),
                            head[start:start + size].float().t())
    y = torch.matmul(hidden.to(torch.bfloat16).float(),
                     head["q"][start:start + size].float().t())
    return y * head["s"][start:start + size].float()


def quantize_weight(w: torch.Tensor, axis: int = -2) -> QTensor:
    """Symmetric int8 with one f32 scale per slice along `axis` (the
    contraction axis): {"q": int8 of w's shape, "s": f32 with `axis`
    removed}."""
    wf = w.float()
    amax = wf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"q": q, "s": scale.squeeze(axis)}


def quantize_head(head: torch.Tensor) -> QTensor:
    """LM head [vocab, d] -> {"q": int8 [vocab, d], "s": f32 [vocab]}."""
    return quantize_weight(head, axis=-1)


def quantize_weight_int4(w: torch.Tensor, group: int = INT4_GROUP
                         ) -> QTensor:
    """Symmetric grouped int4 of w [..., K, N] in groups of min(group, K)
    input rows (JAX `quantize_weight_int4`: the same integers and f32
    scales), packed output-major: {"q4": uint8 [..., N, K/2], "s": f32
    [..., N, K/G]}."""
    q, s = quantize_int4_grouped(w, min(group, w.shape[-2]),
                                 scale_dtype=torch.float32)
    return {"q4": pack_int4(q), "s": s.transpose(-1, -2).contiguous()}


LAYER_MATRICES = ("wqkv", "wo", "w_gate_up", "w_down")


def quantize_decoder_layers(layers: Dict[str, Any]) -> Dict[str, Any]:
    """int8 of the stacked projection matrices ([L, in, out] each); norms
    stay as they are."""
    out = dict(layers)
    for name in LAYER_MATRICES:
        out[name] = quantize_weight(layers[name], axis=-2)
    return out


def quantize_decoder_layers_int4(layers: Dict[str, Any],
                                 group: int = INT4_GROUP) -> Dict[str, Any]:
    """int4 variant of quantize_decoder_layers."""
    out = dict(layers)
    for name in LAYER_MATRICES:
        out[name] = quantize_weight_int4(layers[name], group)
    return out


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
    return packed.reshape(*lead, n, k // 2).to(torch.uint8).contiguous()


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """The inverse of `pack_int4`: uint8 [..., N, K/2] -> int8 [..., K, N]."""
    *lead, n, k2 = packed.shape
    p = packed.to(torch.int16).reshape(*lead, n, k2 // 4, 1, 4)
    nib = torch.cat([p & 0xF, (p >> 4) & 0xF], dim=-2)     # [..., N, K/8, 2, 4]
    vals = (nib ^ 8) - 8                                   # sign-extend
    return vals.reshape(*lead, n, 2 * k2).transpose(-1, -2).to(torch.int8)
