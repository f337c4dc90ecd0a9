"""Multi-token (prefill) causal GQA attention over the stacked KV cache.

`flash_gqa_prefill_stacked` is the port of the Pallas kernel of the same
name (qwen3_tts_tpu/kernels/flash_prefill.py): on a CUDA tensor it launches
the hand-written kernel in `csrc/flash_prefill.cu`; on a CPU tensor it runs
`prefill_attention_plain`, the same function in plain PyTorch.  There is
no other route: a CUDA input the kernel does not take raises.  Unlike the
TPU kernel it takes any S, any window <= C and any group H / Hkv (ragged
tiles are masked in the kernel).  The kernel computes both products on the
tensor cores (mma.sync bf16 -> f32); each launch leaves its grid (CTAs,
warps per CTA) in `flash_gqa_prefill_stacked.grid`.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.attention import gqa_attend, history_mask

HEAD_DIMS = (64, 128)


def prefill_attention_plain(q: torch.Tensor, k_all: torch.Tensor,
                            v_all: torch.Tensor, lengths: torch.Tensor,
                            start: torch.Tensor, layer: int,
                            prompt_cap: int, window: int) -> torch.Tensor:
    """f32 masked-softmax attention of S query rows per lane against slots
    [0, window) of layer `layer` (ops.attention.history_mask +
    gqa_attend).  Returns [B, S, H, Dh] in q.dtype."""
    mask = history_mask(lengths, prompt_cap, start, q.shape[1], window)
    return gqa_attend(q, k_all[layer, :, :, :window],
                      v_all[layer, :, :, :window], mask)


def _check(q, k_all, v_all, lengths, start, layer, window):
    b, s, h, dh = q.shape
    n_layers, kb, hkv, cap, kdh = k_all.shape
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash prefill takes head_dim {HEAD_DIMS}, got {dh}")
    if (kb, kdh) != (b, dh) or v_all.shape != k_all.shape:
        raise ValueError(f"cache {tuple(k_all.shape)} / {tuple(v_all.shape)} "
                         f"does not match q {tuple(q.shape)}")
    if hkv < 1 or h % hkv:
        raise ValueError(f"heads {h} / kv heads {hkv}: not a whole group")
    if not 0 < window <= cap:
        raise ValueError(f"window {window} outside (0, {cap}]")
    if not 0 <= layer < n_layers:
        raise ValueError(f"layer {layer} outside [0, {n_layers})")
    for name, t in (("q", q), ("k_all", k_all), ("v_all", v_all)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous bfloat16, got "
                             f"{t.dtype} contiguous={t.is_contiguous()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    for name, t in (("lengths", lengths), ("start", start)):
        if (t.dtype != torch.int32 or t.shape != (b,)
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous int32 [{b}]")
    for t in (k_all, v_all, lengths, start):
        if t.device != q.device:
            raise ValueError("all inputs must be on the same device")


def flash_gqa_prefill_stacked(q: torch.Tensor, k_all: torch.Tensor,
                              v_all: torch.Tensor, lengths: torch.Tensor,
                              start: torch.Tensor, layer: int,
                              prompt_cap: int, window: int) -> torch.Tensor:
    """Prefill attention against layer `layer` of a stacked cache.

    q: [B, S, H, Dh] bf16 (roped, qk-normed); k_all/v_all: [L, B, Hkv, C,
    Dh] bf16 with the S new rows already written; lengths, start: [B]
    int32 (start = absolute slot of query row 0); window: slots [0,
    window) are readable.  Returns [B, S, H, Dh].  Each launch adds one to
    `flash_gqa_prefill_stacked.launches` and leaves its grid (CTAs, warps
    per CTA) in `flash_gqa_prefill_stacked.grid`.
    """
    if q.device.type == "cpu":
        return prefill_attention_plain(q, k_all, v_all, lengths, start,
                                       layer, prompt_cap, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash prefill runs on cuda or cpu, not {q.device}")
    _check(q, k_all, v_all, lengths, start, layer, window)
    from .build import LIBRARY, check
    b, s, h, dh = q.shape
    hkv, cap = k_all.shape[2], k_all.shape[3]
    out = torch.empty_like(q)
    grid = (ctypes.c_int * 2)()
    # the library launches on (and sets attributes of) the current device
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = LIBRARY.get().qtts_flash_prefill(
            q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(), out.data_ptr(),
            lengths.data_ptr(), start.data_ptr(), int(layer), b, s, h, hkv,
            cap, dh, int(prompt_cap), int(window), dh ** -0.5, grid, stream)
    check(rc, "flash_gqa_prefill_stacked")
    flash_gqa_prefill_stacked.launches += 1
    flash_gqa_prefill_stacked.grid = (grid[0], grid[1])
    return out


flash_gqa_prefill_stacked.launches = 0
flash_gqa_prefill_stacked.grid = (0, 0)
