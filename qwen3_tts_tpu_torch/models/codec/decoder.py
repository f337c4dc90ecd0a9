"""Streaming codec decoder: [frames, 16] codes -> 24 kHz waveform.
Counterpart of qwen3_tts_tpu/models/codec/decoder.py.

An 8-layer, 16-head, d_head-64 latent transformer over summed codebook
embeddings, then a causal conv-transpose upsampler (x2000).  The streaming
state has static shapes: the transformer KV is a ring of `attn_window`
frames with an absolute-position table (sliding-window attention whose
mask derives validity from stored positions), and every causal conv
carries its input history; so chunked decode equals full decode.  The
ring buffers of `DecoderState` are UPDATED IN PLACE by `decode_chunk`;
the conv histories, position table and frame count are replaced.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from ...core.config import CodecDecoderConfig
from ...ops.norms import rms_norm
from ...ops.rope import apply_rope, inv_freq_tensor, rope_cos_sin
from ..transformer import dtype_of, normal

NEG_INF = -1e9


@dataclass
class DecoderState:
    ring_k: torch.Tensor      # [L, B, H, W, Dh] (post-RoPE keys), in place
    ring_v: torch.Tensor      # [L, B, H, W, Dh], in place
    ring_pos: torch.Tensor    # [B, W] int32 absolute frame per slot (-1 empty)
    count: torch.Tensor       # [B] int32 frames decoded so far
    conv_hist: List[torch.Tensor]   # per-causal-conv input history
    # overlapping conv-transpose (upsample_kernel_mult > 1) overlap-add
    # tails, [B, C_out, kernel - stride] each; empty when kernel == stride
    up_tail: List[torch.Tensor] = field(default_factory=list)


def _stage_channels(cfg: CodecDecoderConfig) -> List[Tuple[int, int]]:
    chans = list(cfg.channels)
    pairs = []
    for i in range(len(cfg.upsample_factors)):
        c_in = chans[i]
        c_out = chans[i + 1] if i + 1 < len(chans) else chans[-1]
        pairs.append((c_in, c_out))
    return pairs


def init_decoder_params(cfg: CodecDecoderConfig,
                        generator: torch.Generator) -> Dict[str, Any]:
    """Random codec weights (development mode): the JAX init's shapes,
    scales and dtypes, other draws."""
    dtype = dtype_of(cfg.dtype)
    dev = generator.device
    d, n, h, dh, f = (cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.head_dim,
                      cfg.d_ff)

    def rnd(shape, scale):
        return normal(generator, shape, scale, dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    k = cfg.conv_kernel
    params: Dict[str, Any] = {
        "embed": rnd((cfg.n_codebooks, cfg.codebook_size, d), 0.02),
        "layers": {
            "ln1": ones(n, d), "ln2": ones(n, d),
            "wq": rnd((n, d, h * dh), d ** -0.5),
            "wk": rnd((n, d, h * dh), d ** -0.5),
            "wv": rnd((n, d, h * dh), d ** -0.5),
            "wo": rnd((n, h * dh, d), (h * dh) ** -0.5),
            "w_gate": rnd((n, d, f), d ** -0.5),
            "w_up": rnd((n, d, f), d ** -0.5),
            "w_down": rnd((n, f, d), f ** -0.5),
        },
        "final_norm": ones(d),
        "pre_conv": {"w": rnd((cfg.channels[0], d, k), (d * k) ** -0.5),
                     "b": zeros(cfg.channels[0])},
    }
    m = int(cfg.upsample_kernel_mult)
    stages = []
    for (c_in, c_out), r in zip(_stage_channels(cfg), cfg.upsample_factors):
        stages.append({
            "up_w": rnd((c_out, c_in, r * m), (c_in * r * m) ** -0.5),
            "up_b": zeros(c_out),
            "alpha1": ones(c_out),
            "conv1_w": rnd((c_out, c_out, k), (c_out * k) ** -0.5),
            "conv1_b": zeros(c_out),
            "alpha2": ones(c_out),
            "conv2_w": rnd((c_out, c_out, 1), c_out ** -0.5),
            "conv2_b": zeros(c_out),
        })
    params["stages"] = stages
    c_last = _stage_channels(cfg)[-1][1]
    params["out_conv"] = {"w": rnd((1, c_last, k), (c_last * k) ** -0.5),
                          "b": zeros(1)}
    return params


def init_decoder_state(cfg: CodecDecoderConfig, batch: int,
                       device) -> DecoderState:
    dtype = dtype_of(cfg.dtype)
    n, h, dh, w = cfg.n_layers, cfg.n_heads, cfg.head_dim, cfg.attn_window
    k = cfg.conv_kernel

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    hists = [zeros(batch, cfg.d_model, k - 1)]                  # pre_conv
    hists += [zeros(batch, c_out, k - 1)                         # res conv1
              for _, c_out in _stage_channels(cfg)]
    hists.append(zeros(batch, _stage_channels(cfg)[-1][1], k - 1))  # out
    m = int(cfg.upsample_kernel_mult)
    tails = ([zeros(batch, c_out, (m - 1) * r, dt=torch.float32)
              for (_, c_out), r in zip(_stage_channels(cfg),
                                       cfg.upsample_factors)]
             if m > 1 else [])
    return DecoderState(
        ring_k=zeros(n, batch, h, w, dh), ring_v=zeros(n, batch, h, w, dh),
        ring_pos=torch.full((batch, w), -1, dtype=torch.int32, device=device),
        count=torch.zeros(batch, dtype=torch.int32, device=device),
        conv_hist=hists, up_tail=tails)


def reset_lanes(state: DecoderState, lane_mask: torch.Tensor
                ) -> DecoderState:
    """Zero the streaming state of the lanes where lane_mask[b] (bool [B]
    on the state's device), IN PLACE, with no host sync: continuous
    batching refills those lanes with new streams.  Returns the state."""
    m = lane_mask.to(device=state.count.device, dtype=torch.bool)

    def lanes(t: torch.Tensor, dim: int) -> torch.Tensor:
        return m.reshape((1,) * dim + (-1,) + (1,) * (t.dim() - dim - 1))

    state.ring_k.masked_fill_(lanes(state.ring_k, 1), 0)
    state.ring_v.masked_fill_(lanes(state.ring_v, 1), 0)
    state.ring_pos.masked_fill_(lanes(state.ring_pos, 0), -1)
    state.count.masked_fill_(m, 0)
    for t in list(state.conv_hist) + list(state.up_tail):
        t.masked_fill_(lanes(t, 0), 0)
    return state


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake activation x + sin^2(alpha*x)/alpha (per-channel alpha)."""
    a = alpha[None, :, None].float()
    xf = x.float()
    return (xf + torch.sin(a * xf) ** 2 / (a + 1e-9)).to(x.dtype)


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                hist: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal 1-D conv. x [B, C_in, T], w [C_out, C_in, K], hist
    [B, C_in, K-1].  Inputs are rounded to w.dtype and the conv runs in
    f32 (the JAX conv's preferred_element_type).  Returns (y [B, C_out, T]
    in x.dtype, new_hist)."""
    k = w.shape[-1]
    xx = torch.cat([hist, x], dim=2) if k > 1 else x
    y = F.conv1d(xx.to(w.dtype).float(), w.float())
    y = (y + b[None, :, None].float()).to(x.dtype)
    new_hist = xx[:, :, xx.shape[2] - (k - 1):] if k > 1 else hist
    return y, new_hist


def upsample(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
             ) -> torch.Tensor:
    """Non-overlapping conv-transpose (kernel == stride == r), f32 math:
    x [B, C_in, T] -> [B, C_out, T*r].  Stateless, hence chunk-invariant."""
    y = torch.einsum("bct,ocr->botr", x.float(), w.float())
    y = y + b[None, :, None, None].float()
    bsz, c_out, t, r = y.shape
    return y.reshape(bsz, c_out, t * r).to(x.dtype)


def upsample_overlap(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     tail: torch.Tensor, stride: int,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Overlapping causal conv-transpose (kernel == m*stride, m > 1) by
    streamed overlap-add; the last (m-1)*stride output samples stay in
    `tail` (pre-bias) until the next chunk completes them."""
    k = w.shape[-1]
    m = k // stride
    if k != m * stride or m < 1:
        raise ValueError(f"kernel {k} is not a multiple of stride {stride}")
    bsz, _, t = x.shape
    c_out = w.shape[0]
    y = torch.einsum("bct,ock->botk", x.float(), w.float())
    y = y.reshape(bsz, c_out, t, m, stride)
    acc = torch.zeros(bsz, c_out, t + m - 1, stride, device=x.device)
    for j in range(m):
        acc[:, :, j:j + t] += y[:, :, :, j]
    acc = acc.reshape(bsz, c_out, (t + m - 1) * stride)
    acc[:, :, : (m - 1) * stride] += tail
    out = acc[:, :, : t * stride] + b[None, :, None].float()
    return out.to(x.dtype), acc[:, :, t * stride:].clone()


def _transformer(cfg: CodecDecoderConfig, params, x: torch.Tensor,
                 state: DecoderState) -> Tuple[torch.Tensor, DecoderState]:
    """Sliding-window causal transformer over N new frames; writes the
    new keys/values into the state's ring IN PLACE."""
    b, n, _ = x.shape
    h, dh, w = cfg.n_heads, cfg.head_dim, cfg.attn_window
    dev = x.device
    lay = params["layers"]
    q_pos = state.count.long()[:, None] + torch.arange(n, device=dev)  # [B,N]
    inv_freq = inv_freq_tensor(dh, cfg.rope_theta, dev)
    cos_q, sin_q = rope_cos_sin(q_pos, inv_freq)

    key_pos = torch.cat([state.ring_pos.long(), q_pos], dim=1)   # [B, W+N]
    mask = ((key_pos[:, None, :] >= 0)
            & (key_pos[:, None, :] <= q_pos[:, :, None])
            & (key_pos[:, None, :] > q_pos[:, :, None] - w))
    slots = q_pos % w                                             # [B, N]
    bi = torch.arange(b, device=dev)[:, None]

    for layer in range(cfg.n_layers):
        rk, rv = state.ring_k[layer], state.ring_v[layer]
        hn = rms_norm(x, lay["ln1"][layer], cfg.rms_eps)
        q = (hn @ lay["wq"][layer]).reshape(b, n, h, dh)
        kk = (hn @ lay["wk"][layer]).reshape(b, n, h, dh)
        vv = (hn @ lay["wv"][layer]).reshape(b, n, h, dh)
        q = apply_rope(q, cos_q, sin_q)
        kk = apply_rope(kk, cos_q, sin_q)
        keys = torch.cat([rk, kk.transpose(1, 2)], dim=2)   # [B, H, W+N, Dh]
        vals = torch.cat([rv, vv.transpose(1, 2)], dim=2)
        scores = torch.einsum("bnhd,bhcd->bhnc", q.float(),
                              keys.float()) * dh ** -0.5
        scores = torch.where(mask[:, None], scores,
                             torch.full_like(scores, NEG_INF))
        wts = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhnc,bhcd->bnhd", wts, vals.float())
        x = x + out.reshape(b, n, h * dh).to(x.dtype) @ lay["wo"][layer]
        hn = rms_norm(x, lay["ln2"][layer], cfg.rms_eps)
        ff = F.silu(hn @ lay["w_gate"][layer]) * (hn @ lay["w_up"][layer])
        x = x + ff @ lay["w_down"][layer]
        # ring write, per-lane slots: rk[b, :, slots[b, j]] = kk[b, j]
        rk[bi, :, slots] = kk.to(rk.dtype)
        rv[bi, :, slots] = vv.to(rv.dtype)

    ring_pos = state.ring_pos.clone()
    ring_pos[bi, slots] = q_pos.to(torch.int32)
    state.ring_pos = ring_pos
    state.count = state.count + n
    return rms_norm(x, params["final_norm"], cfg.rms_eps), state


def decode_chunk(cfg: CodecDecoderConfig, params, codes: torch.Tensor,
                 state: DecoderState) -> Tuple[torch.Tensor, DecoderState]:
    """Decode a chunk of frames.

    codes: [B, N, 16] int (clamped to [0, codebook_size)).  Returns (wav
    [B, N * samples_per_frame] f32, state).  The state is advanced: its
    ring buffers in place, its other fields replaced.
    """
    dtype = dtype_of(cfg.dtype)
    b, n, n_q = codes.shape
    safe = torch.clamp(codes.long(), 0, cfg.codebook_size - 1)
    flat = params["embed"].reshape(cfg.n_codebooks * cfg.codebook_size, -1)
    idx = (torch.arange(n_q, device=codes.device)[None, None, :]
           * cfg.codebook_size + safe)
    x = flat[idx].float().sum(dim=2).to(dtype)             # [B, N, d_model]

    x, state = _transformer(cfg, params, x, state)

    hists = list(state.conv_hist)
    y = x.transpose(1, 2)                                  # [B, d_model, N]
    y, hists[0] = causal_conv(y, params["pre_conv"]["w"],
                              params["pre_conv"]["b"], hists[0])
    up_tails = list(state.up_tail)
    for si, (p_stage, r) in enumerate(zip(params["stages"],
                                          cfg.upsample_factors)):
        if p_stage["up_w"].shape[-1] == r:
            y = upsample(y, p_stage["up_w"], p_stage["up_b"])
        else:
            y, up_tails[si] = upsample_overlap(
                y, p_stage["up_w"], p_stage["up_b"], up_tails[si], r)
        res = y
        y = snake(y, p_stage["alpha1"])
        y, hists[si + 1] = causal_conv(y, p_stage["conv1_w"],
                                       p_stage["conv1_b"], hists[si + 1])
        y = snake(y, p_stage["alpha2"])
        y, _ = causal_conv(y, p_stage["conv2_w"], p_stage["conv2_b"],
                           y.new_zeros(b, y.shape[1], 0))
        y = res + y
    y, hists[-1] = causal_conv(y, params["out_conv"]["w"],
                               params["out_conv"]["b"], hists[-1])
    wav = torch.tanh(y[:, 0, :].float())                   # [B, N * spf]
    state.conv_hist = hists
    state.up_tail = up_tails
    return wav, state


def decode_full(cfg: CodecDecoderConfig, params, codes: torch.Tensor,
                batch: int = None) -> torch.Tensor:
    """Non-streaming decode of codes [B, N, 16] from a fresh state (tests,
    offline synthesis).  Returns wav [B, N * samples_per_frame] f32."""
    state = init_decoder_state(cfg, codes.shape[0], codes.device)
    wav, _ = decode_chunk(cfg, params, codes, state)
    return wav
