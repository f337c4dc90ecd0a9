"""Decode attention over the stacked KV cache, and the per-lane cache
writes of continuous batching.

Ports of five Pallas kernels of qwen3_tts_tpu/kernels/flash_decode.py, each
with a plain PyTorch version in this module.  On a CUDA tensor a wrapper
launches its hand-written kernel; on a CPU tensor it runs the plain
version.  There is no other route: a CUDA input a kernel does not take
raises.  Each wrapper counts its launches in `<wrapper>.launches`.

- `flash_gqa_decode` (`csrc/flash_decode.cu`): one query row per lane
  against the live prefix [0, write_idx] of ONE layer's cache
  [B, Hkv, C, Dh], the current token already written; the kernel splits
  the prefix into chunks of SPLIT slots, one CTA each, and merges the
  chunks' softmax partials in chunk order (`decode_split_plain` is that
  algorithm in plain PyTorch, `split_chunks` its chunk plan);
- `flash_gqa_decode_stacked`: the same on layer `layer` of a stacked cache
  [L, B, Hkv, C, Dh]: it calls `flash_gqa_decode` on the view
  k_all[layer] (a pointer offset, no copy), so both count that launch;
- `flash_gqa_decode_append` (`csrc/kv_lanes.cu`): the same attention over
  slots below each lane's own cursor plus the current token, whose k/v row
  the kernel writes into the cache at that cursor (the exact path under
  per-lane cursors); one launch of the talker step's split-prefix items
  (csrc/split_attn.cuh), whose sums `decode_append_kernel_order` replays;
- `inject_prompt_lanes` (`csrc/kv_lanes.cu`): compact prefilled lanes into
  slots [0, S) of chosen lanes of the big cache (lane refill);
- `append_kv_lanes` (`csrc/kv_lanes.cu`): one k/v row per (layer, lane) at
  per-lane cursors (the per-lane talker step).

The last three write INTO the caller's cache and return it; the JAX
functions return new arrays that alias their donated inputs.  The TPU
kernels' 8-row aligned read-modify-write window (a bf16 DMA cannot address
one row) is not carried over: each kernel writes exactly its rows.
"""

from __future__ import annotations

import torch

from ..ops.attention import gqa_attend, history_mask, update_cache

HEAD_DIMS = (64, 128)
MAX_GROUP = 8      # query heads per kv head the kernel takes
SPLIT = 64         # slots per chunk of flash_gqa_decode (csrc/flash_decode.cu)
NEG = -1e30        # the kernels' masked score


def decode_attention_plain(q: torch.Tensor, k_all: torch.Tensor,
                           v_all: torch.Tensor, lengths: torch.Tensor,
                           write_idx: torch.Tensor, layer: int,
                           prompt_cap: int) -> torch.Tensor:
    """f32 masked-softmax attention of one query row per lane against
    layer `layer` of the cache (ops.attention.history_mask +
    gqa_attend).  Returns [B, H, Dh] in q.dtype."""
    return decode_layer_plain(q, k_all[layer], v_all[layer], lengths,
                              write_idx, prompt_cap)


def decode_layer_plain(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, lengths: torch.Tensor,
                       write_idx, prompt_cap: int) -> torch.Tensor:
    """`flash_gqa_decode` in plain PyTorch: f32 masked-softmax attention
    of one query row per lane against one layer's cache [B, Hkv, C, Dh]
    (ops.attention.history_mask + gqa_attend).  Returns [B, H, Dh] in
    q.dtype."""
    mask = history_mask(lengths, prompt_cap, write_idx, 1, k_cache.shape[2])
    return gqa_attend(q[:, None], k_cache, v_cache, mask)[:, 0]


def split_chunks(write_idx: torch.Tensor, capacity: int,
                 split: int = SPLIT) -> torch.Tensor:
    """Chunks of the live prefix [0, min(write_idx + 1, C)) per lane: at
    least one (its CTA writes the output directly), at most ceil(C /
    split), the kernel's grid depth."""
    end = torch.clamp(write_idx.long() + 1, max=capacity)
    return torch.clamp((end + split - 1) // split, min=1)


def decode_split_plain(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, lengths: torch.Tensor,
                       write_idx: torch.Tensor, prompt_cap: int,
                       split: int = SPLIT) -> torch.Tensor:
    """`flash_gqa_decode`'s split-prefix algorithm in plain PyTorch: per
    chunk of `split` slots the f32 scores (masked: NEG), the chunk's max m,
    p = exp(s - m) (masked: 0 exactly), l = sum p and acc = p . V; then
    per head M = max of the chunks' m, and l and acc rescaled by exp(m -
    M) and added chunk by chunk in chunk order (flash_decode_combine).
    Chunks past a lane's prefix hold nothing (m = NEG, l = acc = 0) and
    add nothing.  Returns [B, H, Dh] in q.dtype."""
    b, h, dh = q.shape
    hkv, cap = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    ns = -(-cap // split)
    pad = ns * split - cap
    qs = q.float().reshape(b, hkv, g, dh) * (dh ** -0.5)
    kf = torch.nn.functional.pad(k_cache.float(), (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v_cache.float(), (0, 0, 0, pad))
    valid = history_mask(lengths, prompt_cap, write_idx, 1, ns * split)
    valid = valid[:, 0, None, None, :]                      # [B, 1, 1, C']
    sc = torch.einsum("bkgd,bkcd->bkgc", qs, kf)
    sc = torch.where(valid, sc, torch.tensor(NEG, device=q.device))
    sc = sc.reshape(b, hkv, g, ns, split)
    m = sc.amax(-1)                                         # [B, k, g, ns]
    p = torch.where(valid.reshape(b, 1, 1, ns, split),
                    torch.exp(sc - m[..., None]),
                    torch.zeros((), device=q.device))
    l = p.sum(-1)
    acc = torch.einsum("bkgnc,bkncd->bkgnd", p,
                       vf.reshape(b, hkv, ns, split, dh))
    mx = m.amax(-1)
    big_l = torch.zeros_like(mx)
    big_a = torch.zeros_like(qs)
    for z in range(ns):
        w = torch.exp(m[..., z] - mx)
        big_l = big_l + l[..., z] * w
        big_a = big_a + acc[..., z, :] * w[..., None]
    out = big_a / torch.clamp(big_l, min=1e-30)[..., None]
    return out.reshape(b, h, dh).to(q.dtype)


def decode_workspace(b: int, h: int, hkv: int, capacity: int, dh: int,
                     device) -> torch.Tensor:
    """The kernel's f32 workspace for the chunks' (acc, max, l), or an
    empty tensor where one chunk spans the capacity."""
    ns = -(-capacity // SPLIT)
    n = b * h * ns * (dh + 2) if ns > 1 else 0
    return torch.empty(n, dtype=torch.float32, device=device)


def _check(q, k_cache, v_cache, lengths, write_idx):
    b, h, dh = q.shape
    if k_cache.dim() != 4:
        raise ValueError(f"flash decode takes one layer's cache [B, Hkv, C, "
                         f"Dh], got {tuple(k_cache.shape)}")
    kb, hkv, cap, kdh = k_cache.shape
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash decode takes head_dim {HEAD_DIMS}, got {dh}")
    if (kb, kdh) != (b, dh) or v_cache.shape != k_cache.shape:
        raise ValueError(f"cache {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if h % hkv or h // hkv > MAX_GROUP:
        raise ValueError(f"heads {h} / kv heads {hkv}: group must divide "
                         f"and be <= {MAX_GROUP}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous bfloat16, got "
                             f"{t.dtype} contiguous={t.is_contiguous()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    for name, t in (("lengths", lengths), ("write_idx", write_idx)):
        if (t.dtype != torch.int32 or t.shape != (b,)
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous int32 [{b}]")
    for t in (k_cache, v_cache, lengths, write_idx):
        if t.device != q.device:
            raise ValueError("all inputs must be on the same device")


def _check_stacked(k_all, v_all, layer):
    if k_all.dim() != 5 or v_all.shape != k_all.shape:
        raise ValueError(f"stacked caches [L, B, Hkv, C, Dh], got "
                         f"{tuple(k_all.shape)} / {tuple(v_all.shape)}")
    if not 0 <= layer < k_all.shape[0]:
        raise ValueError(f"layer {layer} outside [0, {k_all.shape[0]})")
    if not (k_all.is_contiguous() and v_all.is_contiguous()):
        raise ValueError("stacked caches must be contiguous")


def flash_gqa_decode(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor,
                     write_idx, prompt_cap: int) -> torch.Tensor:
    """Single-token GQA decode attention over one layer's cache, the
    current token already written at write_idx (JAX `flash_gqa_decode`).

    q: [B, H, Dh] bf16; k_cache/v_cache: [B, Hkv, C, Dh] bf16 (any C);
    lengths: [B] int32; write_idx: [B] int32 or one int for every lane.
    Returns [B, H, Dh].  Each launch adds one to
    `flash_gqa_decode.launches`; one whose capacity spans several chunks,
    which launches the combine kernel (flash_decode_combine) after the
    split kernel, also adds one to `flash_gqa_decode.combine_launches`.
    """
    b = q.shape[0]
    if not torch.is_tensor(write_idx) or write_idx.dim() == 0:
        write_idx = torch.full((b,), int(write_idx), dtype=torch.int32,
                               device=q.device)
    if q.device.type == "cpu":
        return decode_layer_plain(q, k_cache, v_cache, lengths, write_idx,
                                  prompt_cap)
    if q.device.type != "cuda":
        raise ValueError(f"flash decode runs on cuda or cpu, not {q.device}")
    _check(q, k_cache, v_cache, lengths, write_idx)
    from .build import LIBRARY, check
    _, h, dh = q.shape
    hkv, cap = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty_like(q)
    ws = decode_workspace(b, h, hkv, cap, dh, q.device)
    # the library launches on the current device
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = LIBRARY.get().qtts_flash_decode(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            out.data_ptr(), ws.data_ptr() if ws.numel() else None,
            lengths.data_ptr(), write_idx.data_ptr(), b, h, hkv, cap, dh,
            int(prompt_cap), dh ** -0.5, stream)
    check(rc, "flash_gqa_decode")
    flash_gqa_decode.launches += 1
    flash_gqa_decode.combine_launches += ws.numel() > 0
    return out


flash_gqa_decode.launches = 0
flash_gqa_decode.combine_launches = 0


def flash_gqa_decode_stacked(q: torch.Tensor, k_all: torch.Tensor,
                             v_all: torch.Tensor, lengths: torch.Tensor,
                             write_idx: torch.Tensor, layer: int,
                             prompt_cap: int) -> torch.Tensor:
    """Decode attention for the current token (already written at
    write_idx) against layer `layer` of a stacked cache: `flash_gqa_decode`
    on the view k_all[layer].

    q: [B, H, Dh] bf16; k_all/v_all: [L, B, Hkv, C, Dh] bf16 (any C);
    lengths, write_idx: [B] int32.  Returns [B, H, Dh].  Each launch adds
    one to `flash_gqa_decode_stacked.launches` (and, in
    `flash_gqa_decode`, to its count).
    """
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_all, v_all, lengths, write_idx,
                                      layer, prompt_cap)
    _check_stacked(k_all, v_all, layer)
    out = flash_gqa_decode(q, k_all[layer], v_all[layer], lengths,
                           write_idx, prompt_cap)
    flash_gqa_decode_stacked.launches += 1
    return out


flash_gqa_decode_stacked.launches = 0


# ------------------------------------------------- per-lane cursors and refill
def decode_append_plain(q: torch.Tensor, k_all: torch.Tensor,
                        v_all: torch.Tensor, k_new: torch.Tensor,
                        v_new: torch.Tensor, lengths: torch.Tensor,
                        write_idx: torch.Tensor, layer: int,
                        prompt_cap: int) -> torch.Tensor:
    """`flash_gqa_decode_append` in plain PyTorch: write each lane's row at
    write_idx[b] of layer `layer`, then `decode_attention_plain` (whose
    mask keeps the self slot).  Same arguments and effects for cursors in
    [0, C); a lane at a cursor >= C attends [0, C) without its own token."""
    update_cache(k_all[layer], k_new[:, None], write_idx)
    update_cache(v_all[layer], v_new[:, None], write_idx)
    return decode_attention_plain(q, k_all, v_all, lengths, write_idx, layer,
                                  prompt_cap)


def decode_append_kernel_order(q: torch.Tensor, k_all: torch.Tensor,
                               v_all: torch.Tensor, k_new: torch.Tensor,
                               v_new: torch.Tensor, lengths: torch.Tensor,
                               write_idx: torch.Tensor, layer: int,
                               prompt_cap: int) -> torch.Tensor:
    """`flash_gqa_decode_append` in the CUDA kernel's sum orders: each
    lane's row written at write_idx[b] (nothing outside [0, C)), then per
    lane chunk_step._attend_kernel_order (the prefix [0, min(write_idx[b],
    C)) in SPLIT-slot splits combined in split order, 8-lane score dots,
    the current token merged last) with start = that prefix's end and f =
    0, the token's own rows in the slot after the prefix (so a cursor
    outside [0, C) still attends its token).  q, k_new, v_new bf16 values;
    returns [B, H, Dh] bf16.  For the card's checks and the CPU tests: it
    reads each cursor on the host."""
    from .chunk_step import _attend_kernel_order
    b, h, dh = q.shape
    cap = k_all.shape[3]
    out = []
    for i, cursor in enumerate(write_idx.tolist()):
        if 0 <= cursor < cap:
            k_all[layer, i, :, cursor] = k_new[i]
            v_all[layer, i, :, cursor] = v_new[i]
        end = max(0, min(cursor, cap))
        kc = torch.cat([k_all[layer, i:i + 1, :, :end],
                        k_new[i:i + 1, :, None].to(k_all.dtype)], dim=2)
        vc = torch.cat([v_all[layer, i:i + 1, :, :end],
                        v_new[i:i + 1, :, None].to(v_all.dtype)], dim=2)
        out.append(_attend_kernel_order(q[i:i + 1], kc, vc,
                                        lengths[i:i + 1], end, 0,
                                        prompt_cap))
    return torch.cat(out).reshape(b, h, dh)


def append_workspace(k_all: torch.Tensor, h: int):
    """(key, partials, counters) of `flash_gqa_decode_append`'s kernel on
    the cache k_all [L, B, Hkv, C, Dh] with h query heads, kept with that
    cache (talker_step.kept_scratch): f32 [B * Hkv * ceil(C / SPLIT) * G *
    (Dh + 2)] (empty where one split spans the capacity) and int32
    [B * Hkv] zeros, which the kernel's merging warps set back to 0, so a
    launch needs no reset of its own.  One stream at a time per cache;
    made outside CUDA-graph capture (raises inside one if not yet made, as
    its zeroing would only run at replay)."""
    from .talker_step import kept_scratch
    _, b, hkv, cap, dh = k_all.shape
    ns = -(-cap // SPLIT)
    key = ("flash_gqa_decode_append", b, hkv, ns, h // hkv, dh)
    kept = kept_scratch(k_all)
    if key not in kept:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("flash_gqa_decode_append: call it once on "
                               "this cache before CUDA-graph capture (its "
                               "workspace is made and zeroed then)")
        n = b * hkv * ns * (h // hkv) * (dh + 2) if ns > 1 else 0
        kept[key] = (torch.empty(n, dtype=torch.float32, device=k_all.device),
                     torch.zeros(b * hkv, dtype=torch.int32,
                                 device=k_all.device))
    return (key, *kept[key])


def flash_gqa_decode_append(q: torch.Tensor, k_all: torch.Tensor,
                            v_all: torch.Tensor, k_new: torch.Tensor,
                            v_new: torch.Tensor, lengths: torch.Tensor,
                            write_idx: torch.Tensor, layer: int,
                            prompt_cap: int) -> torch.Tensor:
    """Decode attention for the current token at per-lane cursors, with
    its k/v row appended to the cache IN PLACE.

    q: [B, H, Dh] bf16; k_all/v_all: [L, B, Hkv, C, Dh] bf16; k_new/v_new:
    [B, Hkv, Dh] bf16, the current token's rows (not yet written);
    lengths, write_idx: [B] int32.  Slots c < write_idx[b] with c <
    lengths[b] or c >= prompt_cap are visible, and the current token.
    Writes k_new/v_new at (layer, b, :, write_idx[b]) (nothing for a cursor
    outside [0, C)) and returns the attention [B, H, Dh].  On the card one
    launch whose workspace (`append_workspace`) is kept with the cache; a
    failed launch raises and drops it.  Each launch adds one to
    `flash_gqa_decode_append.launches`.
    """
    if q.device.type == "cpu":
        return decode_append_plain(q, k_all, v_all, k_new, v_new, lengths,
                                   write_idx, layer, prompt_cap)
    if q.device.type != "cuda":
        raise ValueError(f"flash decode runs on cuda or cpu, not {q.device}")
    _check_stacked(k_all, v_all, layer)
    _check(q, k_all[layer], v_all[layer], lengths, write_idx)
    b, h, dh = q.shape
    hkv, cap = k_all.shape[2], k_all.shape[3]
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if (tuple(t.shape) != (b, hkv, dh) or t.dtype != torch.bfloat16
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{name} must be contiguous bfloat16 "
                             f"[{b}, {hkv}, {dh}] on {q.device}")
    from .build import LIBRARY, check
    out = torch.empty_like(q)
    key, part, arrive = append_workspace(k_all, h)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = LIBRARY.get().qtts_decode_append(
            q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(),
            k_new.data_ptr(), v_new.data_ptr(), out.data_ptr(),
            lengths.data_ptr(), write_idx.data_ptr(),
            part.data_ptr() if part.numel() else None, part.numel(),
            arrive.data_ptr(), arrive.numel(), int(layer), b, h, hkv, cap,
            dh, int(prompt_cap), dh ** -0.5, stream)
    if rc != 0:
        from .talker_step import kept_scratch
        kept_scratch(k_all).pop(key, None)
    check(rc, "flash_gqa_decode_append")
    flash_gqa_decode_append.launches += 1
    return out


flash_gqa_decode_append.launches = 0


def _check_cache_pair(where, big, v_big, small, v_small, small_rank_dims):
    for name, t in (("k_big", big), ("v_big", v_big), ("k_small", small),
                    ("v_small", v_small)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"{where}: {name} must be contiguous bfloat16, "
                             f"got {t.dtype} contiguous={t.is_contiguous()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{where}: {name} must be 16-byte aligned")
        if t.device != big.device:
            raise ValueError(f"{where}: all inputs must be on one device")
    if big.dim() != 5 or v_big.shape != big.shape:
        raise ValueError(f"{where}: caches must be [L, B, Hkv, C, Dh], got "
                         f"{tuple(big.shape)} / {tuple(v_big.shape)}")
    if v_small.shape != small.shape or small.dim() != small_rank_dims:
        raise ValueError(f"{where}: rows {tuple(small.shape)} / "
                         f"{tuple(v_small.shape)}")
    if big.shape[-1] % 8:
        raise ValueError(f"{where}: head_dim {big.shape[-1]} % 8 != 0")


def inject_prompt_lanes_plain(k_big, v_big, k_small, v_small, lanes):
    """`inject_prompt_lanes` in plain PyTorch (same arguments and effects)."""
    s = k_small.shape[3]
    idx = lanes.long()
    k_big[:, idx, :, :s] = k_small.to(k_big.dtype)
    v_big[:, idx, :, :s] = v_small.to(v_big.dtype)
    return k_big, v_big


def inject_prompt_lanes(k_big: torch.Tensor, v_big: torch.Tensor,
                        k_small: torch.Tensor, v_small: torch.Tensor,
                        lanes: torch.Tensor):
    """Copy R prefilled lanes' prompt k/v into the big cache, IN PLACE.

    k_big/v_big: [L, B, Hkv, C, Dh] bf16; k_small/v_small: [L, R, Hkv, S,
    Dh] bf16 compact prefill caches (S <= C); lanes: [R] int32 target
    lanes, each in [0, B) (the caller checks: a lane outside is skipped by
    the kernel), duplicates allowed only with identical rows.  Slots
    [0, S) of lane lanes[r] take row r; every other slot is untouched.
    Returns (k_big, v_big).  Each launch adds one to
    `inject_prompt_lanes.launches`.
    """
    if k_big.device.type == "cpu":
        return inject_prompt_lanes_plain(k_big, v_big, k_small, v_small,
                                         lanes)
    if k_big.device.type != "cuda":
        raise ValueError(f"inject_prompt_lanes runs on cuda or cpu, not "
                         f"{k_big.device}")
    _check_cache_pair("inject_prompt_lanes", k_big, v_big, k_small, v_small,
                      5)
    n_layers, b, hkv, cap, dh = k_big.shape
    r, s = k_small.shape[1], k_small.shape[3]
    if (k_small.shape[0], k_small.shape[2], k_small.shape[4]) != (
            n_layers, hkv, dh) or s > cap:
        raise ValueError(f"inject_prompt_lanes: rows {tuple(k_small.shape)} "
                         f"do not fit cache {tuple(k_big.shape)}")
    if (lanes.dtype != torch.int32 or tuple(lanes.shape) != (r,)
            or lanes.device != k_big.device or not lanes.is_contiguous()):
        raise ValueError(f"inject_prompt_lanes: lanes must be contiguous "
                         f"int32 [{r}] on {k_big.device}")
    from .build import LIBRARY, check
    with torch.cuda.device(k_big.device):
        stream = torch.cuda.current_stream(k_big.device).cuda_stream
        rc = LIBRARY.get().qtts_inject_lanes(
            k_big.data_ptr(), v_big.data_ptr(), k_small.data_ptr(),
            v_small.data_ptr(), lanes.data_ptr(), n_layers, r, b, hkv, cap,
            s, dh, stream)
    check(rc, "inject_prompt_lanes")
    inject_prompt_lanes.launches += 1
    return k_big, v_big


inject_prompt_lanes.launches = 0


def append_kv_lanes_plain(k_big, v_big, k_tok, v_tok, starts):
    """`append_kv_lanes` in plain PyTorch (same arguments and effects)."""
    for layer in range(k_big.shape[0]):
        update_cache(k_big[layer], k_tok[layer][:, None], starts)
        update_cache(v_big[layer], v_tok[layer][:, None], starts)
    return k_big, v_big


def append_kv_lanes(k_big: torch.Tensor, v_big: torch.Tensor,
                    k_tok: torch.Tensor, v_tok: torch.Tensor,
                    starts: torch.Tensor):
    """Write one token's k/v row per (layer, lane) at per-lane cursors, IN
    PLACE.

    k_big/v_big: [L, B, Hkv, C, Dh] bf16; k_tok/v_tok: [L, B, Hkv, Dh]
    bf16; starts: [B] int32 slots (a cursor outside [0, C) writes
    nothing).  Slot starts[b] of every layer and kv head of lane b takes
    the row; every other slot is untouched.  Returns (k_big, v_big).  Each
    launch adds one to `append_kv_lanes.launches`.
    """
    if k_big.device.type == "cpu":
        return append_kv_lanes_plain(k_big, v_big, k_tok, v_tok, starts)
    if k_big.device.type != "cuda":
        raise ValueError(f"append_kv_lanes runs on cuda or cpu, not "
                         f"{k_big.device}")
    _check_cache_pair("append_kv_lanes", k_big, v_big, k_tok, v_tok, 4)
    n_layers, b, hkv, cap, dh = k_big.shape
    if tuple(k_tok.shape) != (n_layers, b, hkv, dh):
        raise ValueError(f"append_kv_lanes: rows {tuple(k_tok.shape)} do "
                         f"not fit cache {tuple(k_big.shape)}")
    if (starts.dtype != torch.int32 or tuple(starts.shape) != (b,)
            or starts.device != k_big.device or not starts.is_contiguous()):
        raise ValueError(f"append_kv_lanes: starts must be contiguous int32 "
                         f"[{b}] on {k_big.device}")
    from .build import LIBRARY, check
    with torch.cuda.device(k_big.device):
        stream = torch.cuda.current_stream(k_big.device).cuda_stream
        rc = LIBRARY.get().qtts_append_lanes(
            k_big.data_ptr(), v_big.data_ptr(), k_tok.data_ptr(),
            v_tok.data_ptr(), starts.data_ptr(), n_layers, b, hkv, cap, dh,
            stream)
    check(rc, "append_kv_lanes")
    append_kv_lanes.launches += 1
    return k_big, v_big


append_kv_lanes.launches = 0
