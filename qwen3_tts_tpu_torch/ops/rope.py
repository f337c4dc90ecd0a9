"""Rotary position embeddings: standard RoPE and Qwen M-RoPE.
Counterpart of qwen3_tts_tpu/ops/rope.py.

The talker uses M-RoPE with four position rows per token (temporal, height,
width, channel); frequencies are split into contiguous per-row sections
(in half-dims, summing to head_dim // 2).  With T=H=W=pos and channel=0
this reduces to standard RoPE, which `rope_cos_sin` gives directly.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch


def inv_frequencies(head_dim: int, theta: float) -> np.ndarray:
    """Standard RoPE inverse frequencies, shape [head_dim // 2] (f32)."""
    return (1.0 / theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                            / head_dim)).astype(np.float32)


def section_ids(sections: Sequence[int]) -> np.ndarray:
    """Map each of the head_dim//2 frequencies to its owning position row."""
    return np.concatenate([np.full(s, i, np.int32)
                           for i, s in enumerate(sections)])


@functools.lru_cache(maxsize=32)
def inv_freq_tensor(head_dim: int, theta: float,
                    device: torch.device) -> torch.Tensor:
    """`inv_frequencies` as a tensor on `device`, made once per process:
    a fresh host-to-device copy on every decode step would make the host
    wait for the device each time.  Callers must not modify it."""
    return torch.from_numpy(inv_frequencies(head_dim, theta)).to(device)


@functools.lru_cache(maxsize=32)
def section_ids_tensor(sections: Tuple[int, ...],
                       device: torch.device) -> torch.Tensor:
    """`section_ids` as a tensor on `device`, made once per process."""
    return torch.from_numpy(section_ids(sections)).to(device)


def mrope_cos_sin(pos4: torch.Tensor, inv_freq: torch.Tensor,
                  sec_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for M-RoPE.

    pos4: int [..., 4] positions (temporal, height, width, channel).
    Returns (cos, sin), each [..., head_dim] f32 with the half-table
    duplicated.
    """
    idx = sec_ids.long().expand(*pos4.shape[:-1], sec_ids.shape[0])
    pos = torch.gather(pos4.long(), -1, idx)
    angles = pos.float() * inv_freq
    cos, sin = torch.cos(angles), torch.sin(angles)
    return torch.cat([cos, cos], dim=-1), torch.cat([sin, sin], dim=-1)


def rope_cos_sin(pos: torch.Tensor, inv_freq: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Standard RoPE cos/sin: pos int [...] -> each [..., head_dim] f32."""
    angles = pos.float()[..., None] * inv_freq
    cos, sin = torch.cos(angles), torch.sin(angles)
    return torch.cat([cos, cos], dim=-1), torch.cat([sin, sin], dim=-1)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Apply rotary embedding. x: [..., n_heads, head_dim]; cos/sin
    [..., head_dim] broadcast over the heads axis.  Math in f32."""
    cos = cos[..., None, :].float()
    sin = sin[..., None, :].float()
    xf = x.float()
    return (xf * cos + rotate_half(xf) * sin).to(x.dtype)


def make_mrope_positions(start, length: int) -> np.ndarray:
    """Host helper (the reference's engine.rs:306-314): [length, 4] int32
    with T = H = W = arange from `start` and channel row 0."""
    r = np.arange(start, start + length, dtype=np.int32)
    return np.stack([r, r, r, np.zeros_like(r)], axis=-1)
