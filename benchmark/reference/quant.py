"""The weight formats a configuration serves, worked out again from the
benchmark's own weights, and the lower precision of the control.

Each format turns a weight into the f32 values that the served integers
and scales stand for, by the published quantizers' arithmetic:

- "plain": the weight as made (bf16 values, read in f32);
- "int8_col": symmetric int8 per output column of w [K, N], scale
  max(amax, 1e-8) / 127 in f32 (a GGUF q8_0-style int8 device weight);
- "int8_col_a8": the same weights; the activations are quantized per row
  to int8 too (scale amax / 127);
- "w4a8_bf16s": symmetric int4 in groups of 128 rows of K, scale
  max(amax, 1e-8) / 7 in f32 for the integers, stored in bf16; the
  activations quantized per row to int8 (scale amax * f32(1 / 127));
- "w4a8_f32s": the same with the scales stored in f32;
- "w4a8_f32s_cmajor": w4a8_f32s of an attention output projection whose
  input rows are first put in c-major head order (query head j * rep + c
  of kv head j at position c * n_kv + j), so that the groups of 128 rows
  fall on those heads; the values are put back in head order after;
- heads [V, d]: "plain", or "int8_row" (one scale per row of V).

Nothing here imports the program.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

GROUP = 128
INV127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()


def int8_cols(w: torch.Tensor) -> torch.Tensor:
    wf = w.float()
    s = torch.clamp(wf.abs().amax(dim=-2, keepdim=True), min=1e-8) / 127.0
    return torch.clamp(torch.round(wf / s), -127, 127) * s


def int8_rows(w: torch.Tensor) -> torch.Tensor:
    return int8_cols(w.t()).t()


def int4_groups(w: torch.Tensor, scale_dtype: torch.dtype) -> torch.Tensor:
    wf = w.float()
    k, n = wf.shape
    g = wf.reshape(k // GROUP, GROUP, n)
    s = torch.clamp(g.abs().amax(dim=1, keepdim=True), min=1e-8) / 7.0
    q = torch.clamp(torch.round(g / s), -7, 7)
    return (q * s.to(scale_dtype).float()).reshape(k, n)


def c_major_rows(n_heads: int, n_kv: int, head_dim: int) -> torch.Tensor:
    rep = n_heads // n_kv
    heads = [(i % n_kv) * rep + i // n_kv for i in range(n_heads)]
    return torch.cat([torch.arange(head_dim) + h * head_dim for h in heads])


def weight(w: torch.Tensor, fmt: str, heads: Optional[tuple] = None
           ) -> torch.Tensor:
    """f32 values of matrix w [K, N] served in format `fmt`.  heads:
    (n_heads, n_kv, head_dim) for the c-major format of an output
    projection."""
    if fmt == "plain":
        return w.float()
    if fmt in ("int8_col", "int8_col_a8"):
        return int8_cols(w)
    if fmt == "w4a8_bf16s":
        return int4_groups(w, torch.bfloat16)
    if fmt == "w4a8_f32s":
        return int4_groups(w, torch.float32)
    if fmt == "w4a8_f32s_cmajor":
        if heads is None:
            return int4_groups(w, torch.float32)
        rows = c_major_rows(*heads).to(w.device)
        out = torch.empty(w.shape, dtype=torch.float32, device=w.device)
        out[rows] = int4_groups(w[rows], torch.float32)
        return out
    raise ValueError(f"unknown weight format {fmt!r}")


def head(w: torch.Tensor, fmt: str) -> torch.Tensor:
    """f32 values of an LM head [V, d] served in format `fmt`."""
    if fmt == "plain":
        return w.float()
    if fmt == "int8_row":
        return int8_rows(w)
    raise ValueError(f"unknown head format {fmt!r}")


def activation_rule(fmt: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """What the format does to a matmul's input rows (f32 [..., K])."""
    if fmt == "int8_col_a8":
        def a8(x):
            sx = torch.clamp(x.abs().amax(-1, keepdim=True), min=1e-8) / 127.0
            return torch.round(x / sx) * sx
        return a8
    if fmt.startswith("w4a8"):
        def a8m(x):
            sx = torch.clamp(x.abs().amax(-1, keepdim=True), min=1e-8) * INV127
            return torch.round(x / sx) * sx
        return a8m
    return lambda x: x


def fp8(x: torch.Tensor) -> torch.Tensor:
    """The control's activations: rounded to float8 e4m3 (saturating at
    +-448), the step below the configurations' bfloat16."""
    return torch.clamp(x, -448.0, 448.0).to(torch.float8_e4m3fn).float()


def exact(x: torch.Tensor) -> torch.Tensor:
    return x
