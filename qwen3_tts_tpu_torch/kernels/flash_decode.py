"""Single-token GQA decode attention over the stacked KV cache.

`flash_gqa_decode_stacked` is the port of the Pallas kernel of the same
name (qwen3_tts_tpu/kernels/flash_decode.py): on a CUDA tensor it launches
the hand-written kernel in `csrc/flash_decode.cu`, which reads only the
live prefix [0, write_idx] of one layer; on a CPU tensor it runs
`decode_attention_plain`, the same function in plain PyTorch.  There is no
other route: a CUDA input the kernel does not take raises.
"""

from __future__ import annotations

import torch

from ..ops.attention import gqa_attend, history_mask

HEAD_DIMS = (64, 128)
MAX_GROUP = 8      # query heads per kv head the kernel takes


def decode_attention_plain(q: torch.Tensor, k_all: torch.Tensor,
                           v_all: torch.Tensor, lengths: torch.Tensor,
                           write_idx: torch.Tensor, layer: int,
                           prompt_cap: int) -> torch.Tensor:
    """f32 masked-softmax attention of one query row per lane against
    layer `layer` of the cache (ops.attention.history_mask +
    gqa_attend).  Returns [B, H, Dh] in q.dtype."""
    cap = k_all.shape[3]
    mask = history_mask(lengths, prompt_cap, write_idx, 1, cap)
    return gqa_attend(q[:, None], k_all[layer], v_all[layer], mask)[:, 0]


def _check(q, k_all, v_all, lengths, write_idx, layer):
    b, h, dh = q.shape
    n_layers, kb, hkv, cap, kdh = k_all.shape
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash decode takes head_dim {HEAD_DIMS}, got {dh}")
    if (kb, kdh) != (b, dh) or v_all.shape != k_all.shape:
        raise ValueError(f"cache {tuple(k_all.shape)} / {tuple(v_all.shape)} "
                         f"does not match q {tuple(q.shape)}")
    if h % hkv or h // hkv > MAX_GROUP:
        raise ValueError(f"heads {h} / kv heads {hkv}: group must divide "
                         f"and be <= {MAX_GROUP}")
    if not 0 <= layer < n_layers:
        raise ValueError(f"layer {layer} outside [0, {n_layers})")
    for name, t in (("q", q), ("k_all", k_all), ("v_all", v_all)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous bfloat16, got "
                             f"{t.dtype} contiguous={t.is_contiguous()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    for name, t in (("lengths", lengths), ("write_idx", write_idx)):
        if (t.dtype != torch.int32 or t.shape != (b,)
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous int32 [{b}]")
    for t in (k_all, v_all, lengths, write_idx):
        if t.device != q.device:
            raise ValueError("all inputs must be on the same device")


def flash_gqa_decode_stacked(q: torch.Tensor, k_all: torch.Tensor,
                             v_all: torch.Tensor, lengths: torch.Tensor,
                             write_idx: torch.Tensor, layer: int,
                             prompt_cap: int) -> torch.Tensor:
    """Decode attention for the current token (already written at
    write_idx) against layer `layer` of a stacked cache.

    q: [B, H, Dh] bf16; k_all/v_all: [L, B, Hkv, C, Dh] bf16 (any C);
    lengths, write_idx: [B] int32.  Returns [B, H, Dh].  Each launch adds
    one to `flash_gqa_decode_stacked.launches`.
    """
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_all, v_all, lengths, write_idx,
                                      layer, prompt_cap)
    if q.device.type != "cuda":
        raise ValueError(f"flash decode runs on cuda or cpu, not {q.device}")
    _check(q, k_all, v_all, lengths, write_idx, layer)
    from .build import LIBRARY, check
    b, h, dh = q.shape
    hkv, cap = k_all.shape[2], k_all.shape[3]
    out = torch.empty_like(q)
    # the library launches on the current device
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = LIBRARY.get().qtts_flash_decode(
            q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(), out.data_ptr(),
            lengths.data_ptr(), write_idx.data_ptr(), int(layer), b, h, hkv,
            cap, dh, int(prompt_cap), dh ** -0.5, stream)
    check(rc, "flash_gqa_decode_stacked")
    flash_gqa_decode_stacked.launches += 1
    return out


flash_gqa_decode_stacked.launches = 0
