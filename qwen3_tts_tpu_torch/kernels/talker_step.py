"""One talker decode step over all layers, with w4a8 weights.

`talker_step_fused` is the port of the Pallas kernel of the same name
(qwen3_tts_tpu/kernels/talker_step.py) in its default weight mode, w4a8:
grouped int4 weights (prepared once by `prep_layer_weights`) times int8
activations quantized per row on the fly.  On a CUDA tensor it makes ONE
call into `csrc/talker_step.cu`, which launches the layers' kernels on the
current stream; on a CPU tensor it runs `talker_step_plain`, the same
function in plain PyTorch.  There is no other route: a CUDA input the
kernel does not take raises.

Numerics follow the JAX kernel op for op (`_qmm4`, `_rms`, `_blk_rms`,
the B <= 4 attention loop):
- each matmul quantizes its input row over the whole K (sx = max(amax,
  1e-8) * f32(1/127), xq = round_half_even(x / sx)), takes one exact
  integer dot per group of 128 K rows, and sums the groups in f32 in the
  JAX order (group i, then group nb + i, for i < nb = K / 256), times the
  bf16 scales; the result is bf16(acc * sx);
- RMSNorm in f32 then bf16; per-head q/k RMSNorm then bf16; rope in f32
  then bf16; bf16 residual adds; SwiGLU as bf16(silu_f32(gate)) * up;
- attention: q pre-scaled by head_dim**-0.5 in f32, f32 scores and
  softmax; cache slot c is visible iff c < lengths[b] or
  prompt_cap <= c < write_idx[b]; the current token is one more column,
  always visible.
The step writes each layer's k/v row into the cache at write_idx IN PLACE
and returns the hidden state BEFORE the final norm.  Every lane has its own
cursor write_idx[b].  With uniform_cursor=True (one request, all cursors
equal) the kernel writes each row into the cache as it goes; with
uniform_cursor=False (continuous batching) it writes the rows into a
[L, B, Hkv, Dh] token buffer, and one `flash_decode.append_kv_lanes` launch
after the last layer writes them, as the JAX kernel does.  Attention never
reads the slot being written (the prefix loop stops below the cursor and
the current token comes from registers), so both modes give the same
numbers, and the plain version serves both.

Batches: 1-4 lanes, or a multiple of 8 up to 96 (the JAX gate).  The
kernel runs the batch rows of each matmul in tiles of at most 8; each
lane's arithmetic is that of batch 1, so a lane's outputs equal the
1-lane kernel's bit for bit.  Attention scores stay f32 at every batch
(the JAX batched loop's bf16 score inputs are a TPU matrix-unit artefact).

The JAX kernel's other weight modes (int8, w8a8, bf16) and its tuning
switches are not ported.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..ops.quant import (INT4_GROUP, pack_int4, quantize_int4_grouped,
                         unpack_int4)
from ..ops.attention import update_cache
from .flash_decode import append_kv_lanes

MAX_BATCH = 96        # 1-4 lanes, or a multiple of 8 up to this
MAX_GROUP = 8          # query heads per kv head the attention kernel takes
INV127 = 1.0 / 127.0   # a Python float: becomes f32(1/127), as in JAX


def unsupported(cfg, batch: int) -> Optional[str]:
    """The first gate `cfg` at `batch` fails, or None.  The JAX gate
    (talker_step.supported, w4a8: decode batches 1-4, or a multiple of 8
    up to 96) plus what the port's attention kernel needs (at most
    MAX_GROUP query heads per kv head)."""
    g2 = 2 * INT4_GROUP
    gates = (
        (1 <= batch <= 4 or (batch % 8 == 0 and 8 <= batch <= MAX_BATCH),
         f"batch {batch} is not 1-4 or a multiple of 8 up to {MAX_BATCH}"),
        (cfg.qk_norm, "qk_norm is off"),
        (cfg.head_dim == 128, f"head_dim {cfg.head_dim} != 128"),
        (cfg.n_heads % cfg.n_kv_heads == 0,
         f"n_heads {cfg.n_heads} % n_kv_heads {cfg.n_kv_heads} != 0"),
        (cfg.n_heads // cfg.n_kv_heads <= MAX_GROUP,
         f"more than {MAX_GROUP} query heads per kv head"),
        (cfg.d_model % g2 == 0, f"d_model {cfg.d_model} % {g2} != 0"),
        (cfg.n_heads * cfg.head_dim % g2 == 0,
         f"n_heads * head_dim {cfg.n_heads * cfg.head_dim} % {g2} != 0"),
        (cfg.d_ff % g2 == 0, f"d_ff {cfg.d_ff} % {g2} != 0"),
    )
    for ok, why in gates:
        if not ok:
            return f"talker_step: {why}"
    return None


def supported(cfg, batch: int) -> bool:
    return unsupported(cfg, batch) is None


def prep_layer_weights(cfg, params) -> Dict[str, Any]:
    """Kernel-ready w4a8 form of the stacked talker layers, made once:
    f32 norms [L, D] and [L, head_dim] (not tiled), and per matrix
    `<m>_q` uint8 [L, N, K/2] (ops.quant.pack_int4 layout) with `<m>_s`
    bf16 [L, N, K/128] (scales of each output column's K groups).
    Quantized one layer at a time, on the weights' device."""
    lw = params["layers"]

    def q4(w):
        packed, scales = [], []
        for layer in range(w.shape[0]):
            q, s = quantize_int4_grouped(w[layer])
            packed.append(pack_int4(q))
            scales.append(s.t().contiguous())
        return torch.stack(packed), torch.stack(scales)

    out = {"ln1": lw["ln1"].float().contiguous(),
           "ln2": lw["ln2"].float().contiguous(),
           "qn": lw["q_norm"].float().contiguous(),
           "kn": lw["k_norm"].float().contiguous()}
    for name, key in (("wqkv", "wqkv"), ("wo", "wo"), ("gu", "w_gate_up"),
                      ("dn", "w_down")):
        out[name + "_q"], out[name + "_s"] = q4(lw[key])
    return out


# ------------------------------------------------------------- plain version
def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """JAX `_rms`: f32 (x * rsqrt(mean(x^2) + eps)) * w, unrounded."""
    xf = x.float()
    inv = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * inv) * w.float()


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def qmm4_plain(x: torch.Tensor, wq: torch.Tensor,
               ws: torch.Tensor) -> torch.Tensor:
    """w4a8 matmul, JAX `_qmm4`: x bf16 [B, K] by packed wq uint8
    [N, K/2] with scales ws bf16 [N, K/128] -> bf16 [B, N].  The group
    dots are integers below 2^24, so the f32 einsum computes them
    exactly, in any order."""
    b, k = x.shape
    n = wq.shape[0]
    ng = k // INT4_GROUP
    nb = ng // 2
    xf = x.float()
    sx = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-8) * INV127
    xq = torch.round(xf / sx)
    q = unpack_int4(wq).float().reshape(ng, INT4_GROUP, n)
    d = torch.einsum("bgk,gkn->bgn", xq.reshape(b, ng, INT4_GROUP), q)
    s = ws.float().t()                                   # [ng, N]
    acc = torch.zeros(b, n, dtype=torch.float32, device=x.device)
    for i in range(nb):
        acc = acc + d[:, i] * s[i]
        acc = acc + d[:, nb + i] * s[nb + i]
    return (acc * sx).to(torch.bfloat16)


def _attend_plain(q, kc, vc, lengths, write_idx, prompt_cap):
    """q [B, H, Dh] bf16 against one layer's cache [B, Hkv, C, Dh], in
    which the current token is already written at write_idx."""
    b, h, dh = q.shape
    hkv, cap = kc.shape[1], kc.shape[2]
    qs = q.float().reshape(b, hkv, h // hkv, dh) * (dh ** -0.5)
    scores = torch.einsum("bkgd,bkcd->bkgc", qs, kc.float())
    c = torch.arange(cap, device=q.device)[None, :]
    wi = write_idx.long()[:, None]
    valid = ((c < lengths.long()[:, None])
             | ((c >= prompt_cap) & (c < wi)) | (c == wi))      # [B, C]
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bkgc,bkcd->bkgd", p, vc.float())
    return ctx.reshape(b, h * dh).to(torch.bfloat16)


def talker_step_plain(cfg, w, x, cos, sin, cache_k, cache_v, lengths,
                      write_idx, prompt_cap: int) -> torch.Tensor:
    """`talker_step_fused` in plain PyTorch (same arguments and effects,
    but for uniform_cursor: that changes only where the kernel stages its
    k/v rows, so the plain version writes each layer's rows at once)."""
    b = x.shape[0]
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dq, dkv, eps = h * dh, hkv * dh, cfg.rms_eps
    cos = cos.float()[:, None, :]
    sin = sin.float()[:, None, :]
    x = x.to(torch.bfloat16)
    for layer in range(cfg.n_layers):
        def mm(v, name):
            return qmm4_plain(v, w[name + "_q"][layer], w[name + "_s"][layer])

        hn = _rms(x, w["ln1"][layer], eps).to(torch.bfloat16)
        qkv = mm(hn, "wqkv")
        q = qkv[:, :dq].reshape(b, h, dh)
        k = qkv[:, dq:dq + dkv].reshape(b, hkv, dh)
        v = qkv[:, dq + dkv:].reshape(b, hkv, dh)
        q = _rms(q, w["qn"][layer], eps).to(torch.bfloat16).float()
        k = _rms(k, w["kn"][layer], eps).to(torch.bfloat16).float()
        q = (q * cos + _rotate_half(q) * sin).to(torch.bfloat16)
        k = (k * cos + _rotate_half(k) * sin).to(torch.bfloat16)
        update_cache(cache_k[layer], k[:, None], write_idx)
        update_cache(cache_v[layer], v[:, None], write_idx)
        ctx = _attend_plain(q, cache_k[layer], cache_v[layer], lengths,
                            write_idx, prompt_cap)
        x = x + mm(ctx, "wo")
        hn2 = _rms(x, w["ln2"][layer], eps).to(torch.bfloat16)
        gu = mm(hn2, "gu")
        f = gu.shape[-1] // 2
        ff = F.silu(gu[:, :f].float()).to(torch.bfloat16) * gu[:, f:]
        x = x + mm(ff, "dn")
    return x


# ------------------------------------------------------------------- kernel
_WEIGHTS = ("ln1", "ln2", "qn", "kn", "wqkv_q", "wqkv_s", "wo_q", "wo_s",
            "gu_q", "gu_s", "dn_q", "dn_s")


def _check(cfg, w, x, cos, sin, cache_k, cache_v, lengths, write_idx):
    b, d = x.shape
    why = unsupported(cfg, b)
    if why:
        raise ValueError(why)
    L, dh, hkv = cfg.n_layers, cfg.head_dim, cfg.n_kv_heads
    dq, f = cfg.n_heads * dh, cfg.d_ff
    nqkv = dq + 2 * hkv * dh
    g = INT4_GROUP
    want = {"ln1": ((L, d), torch.float32), "ln2": ((L, d), torch.float32),
            "qn": ((L, dh), torch.float32), "kn": ((L, dh), torch.float32),
            "wqkv_q": ((L, nqkv, d // 2), torch.uint8),
            "wqkv_s": ((L, nqkv, d // g), torch.bfloat16),
            "wo_q": ((L, d, dq // 2), torch.uint8),
            "wo_s": ((L, d, dq // g), torch.bfloat16),
            "gu_q": ((L, 2 * f, d // 2), torch.uint8),
            "gu_s": ((L, 2 * f, d // g), torch.bfloat16),
            "dn_q": ((L, d, f // 2), torch.uint8),
            "dn_s": ((L, d, f // g), torch.bfloat16)}
    tensors = {k: w[k] for k in _WEIGHTS}
    tensors.update(x=x, cos=cos, sin=sin, cache_k=cache_k, cache_v=cache_v,
                   lengths=lengths, write_idx=write_idx)
    cap = cache_k.shape[3]
    want.update(x=((b, d), torch.bfloat16), cos=((b, dh), torch.float32),
                sin=((b, dh), torch.float32),
                cache_k=((L, b, hkv, cap, dh), torch.bfloat16),
                cache_v=((L, b, hkv, cap, dh), torch.bfloat16),
                lengths=((b,), torch.int32), write_idx=((b,), torch.int32))
    for name, t in tensors.items():
        shape, dtype = want[name]
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"talker_step: {name} must be {dtype} "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"talker_step: {name} must be contiguous and "
                             "16-byte aligned")
        if t.device != x.device:
            raise ValueError("talker_step: all inputs must be on one device")


def talker_step_fused(cfg, w, x, cos, sin, cache_k, cache_v, lengths,
                      write_idx, prompt_cap: int,
                      uniform_cursor: bool = True) -> torch.Tensor:
    """One decode step over all layers.

    w: `prep_layer_weights(cfg, params)`; x [B, D] bf16 input embedding;
    cos/sin [B, head_dim] f32 rope rows of each lane's position; cache_k/v
    [L, B, Hkv, C, Dh] bf16, written IN PLACE at write_idx; lengths and
    write_idx [B] int32.  uniform_cursor=False stages the k/v rows and
    appends them with one append_kv_lanes launch (module docstring).
    Returns the hidden state [B, D] bf16 BEFORE the final norm.  Each
    kernel call adds one to `talker_step_fused.launches`.
    """
    if x.device.type == "cpu":
        return talker_step_plain(cfg, w, x, cos, sin, cache_k, cache_v,
                                 lengths, write_idx, prompt_cap)
    if x.device.type != "cuda":
        raise ValueError(f"talker_step runs on cuda or cpu, not {x.device}")
    _check(cfg, w, x, cos, sin, cache_k, cache_v, lengths, write_idx)
    from .build import LIBRARY, check
    b, d = x.shape
    h, hkv, dh, f = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    out = torch.empty_like(x)
    qkv = torch.empty(b, (h + 2 * hkv) * dh, dtype=torch.bfloat16,
                      device=x.device)
    ctx = torch.empty(b, h * dh, dtype=torch.bfloat16, device=x.device)
    ff = torch.empty(b, f, dtype=torch.bfloat16, device=x.device)
    tok = [None, None] if uniform_cursor else [
        torch.empty(cfg.n_layers, b, hkv, dh, dtype=torch.bfloat16,
                    device=x.device) for _ in range(2)]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = LIBRARY.get().qtts_talker_step(
            x.data_ptr(), out.data_ptr(), cos.data_ptr(), sin.data_ptr(),
            *[w[k].data_ptr() for k in _WEIGHTS],
            cache_k.data_ptr(), cache_v.data_ptr(), lengths.data_ptr(),
            write_idx.data_ptr(), qkv.data_ptr(), ctx.data_ptr(),
            ff.data_ptr(), *[0 if t is None else t.data_ptr() for t in tok],
            cfg.n_layers, b, d, h, hkv, dh, f,
            cache_k.shape[3], int(prompt_cap), float(cfg.rms_eps),
            dh ** -0.5, stream)
    check(rc, "talker_step_fused")
    talker_step_fused.launches += 1
    if not uniform_cursor:
        append_kv_lanes(cache_k, cache_v, *tok, write_idx)
    return out


talker_step_fused.launches = 0
