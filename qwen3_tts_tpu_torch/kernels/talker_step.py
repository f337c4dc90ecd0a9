"""One talker decode step over all layers, in four weight modes.

`talker_step_fused` is the port of the Pallas kernel of the same name
(qwen3_tts_tpu/kernels/talker_step.py).  On a CUDA tensor it makes ONE
call into `csrc/talker_step.cu`, which launches the layers' kernels on the
current stream; on a CPU tensor it runs `talker_step_plain`, the same
function in plain PyTorch.  There is no other route: a CUDA input the
kernel does not take raises.

Weight modes (`MODES`, the JAX kernel's `weights=`; `prep_layer_weights`
makes each mode's weights once, from bf16 or int8-dict layers, with the
JAX prep's integers):
- "w4a8" (the default): grouped int4 weights (bf16 group scales) times
  int8 activations quantized per row on the fly (JAX `_qmm4`);
- "int8": int8 weights with f32 per-column scales; the matmul is
  bf16(sum bf16(x) * bf16(q) in f32) * bf16(s), a bf16 multiply (JAX
  `_qmm`, exact `ops.quant.matmul` numerics);
- "w8a8": the same int8 weights times int8 activations (sx = max(amax,
  1e-8) * f32(1/127), xq = round_half_even(x / sx)), an exact int32 dot,
  then bf16(f32(acc) * sx * s) (JAX `_qmm(w8a8=True)`);
- "bf16": pre-dequantized bf16(q * s) weights with unit scales, the int8
  mode's dot (JAX `_qmm` on bf16 weights).

Numerics follow the JAX kernel op for op (`_qmm4`, `_qmm`, `_rms`,
`_blk_rms`, the B <= 4 attention loop):
- w4a8: each matmul quantizes its input row over the whole K, takes one
  exact integer dot per group of 128 K rows, and sums the groups in f32
  in the JAX order (group i, then group nb + i, for i < nb = K / 256),
  times the bf16 scales; the result is bf16(acc * sx);
- RMSNorm in f32 then bf16; per-head q/k RMSNorm then bf16; rope in f32
  then bf16; bf16 residual adds; SwiGLU as bf16(silu_f32(gate)) * up;
- attention: q pre-scaled by head_dim**-0.5 in f32, f32 scores and
  softmax; cache slot c is visible iff c < lengths[b] or
  prompt_cap <= c < write_idx[b]; the current token is one more column,
  always visible.
The int8 and bf16 modes' f32 dot sums in another order than XLA's, so
they agree with the JAX kernel to rounding; w4a8 and w8a8 take exact
integer dots and agree bit for bit (with XLA's excess precision off).
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
The JAX kernel's tuning switches (lps, sfold, its DMA schedule) are TPU
workarounds and are not ported.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.quant import (INT4_GROUP, dequantize, is_quantized, pack_int4,
                         quantize_int4_grouped, quantize_weight, take,
                         unpack_int4)
from ..ops.attention import update_cache
from .flash_decode import append_kv_lanes

MAX_BATCH = 96        # 1-4 lanes, or a multiple of 8 up to this
MAX_GROUP = 8          # query heads per kv head the attention kernel takes
MAX_K = 8192           # contraction dims the GEMVs' shared memory takes
INV127 = 1.0 / 127.0   # a Python float: becomes f32(1/127), as in JAX
MODES = ("w4a8", "int8", "w8a8", "bf16")   # index = the C entry's `mode`


def unsupported(cfg, batch: int, mode: str = "w4a8") -> Optional[str]:
    """The first gate `cfg` at `batch` fails in weight mode `mode`, or
    None.  The JAX gate (talker_step.supported: decode batches 1-4, or a
    multiple of 8 up to 96; w4a8 needs whole 256-row nibble groups) plus
    what the port's kernel needs (at most MAX_GROUP query heads per kv
    head; contraction dims of whole 64-byte blocks in w8a8, whose tensor-core
    dots take them so, and of whole 16-byte vectors in int8 and bf16, up to
    MAX_K)."""
    if mode not in MODES:
        return f"talker_step: mode {mode!r} is not one of {MODES}"
    g = {"w4a8": 2 * INT4_GROUP, "w8a8": 64}.get(mode, 16)
    dq = cfg.n_heads * cfg.head_dim
    gates = (
        (1 <= batch <= 4 or (batch % 8 == 0 and 8 <= batch <= MAX_BATCH),
         f"batch {batch} is not 1-4 or a multiple of 8 up to {MAX_BATCH}"),
        (cfg.qk_norm, "qk_norm is off"),
        (cfg.head_dim == 128, f"head_dim {cfg.head_dim} != 128"),
        (cfg.n_heads % cfg.n_kv_heads == 0,
         f"n_heads {cfg.n_heads} % n_kv_heads {cfg.n_kv_heads} != 0"),
        (cfg.n_heads // cfg.n_kv_heads <= MAX_GROUP,
         f"more than {MAX_GROUP} query heads per kv head"),
        (cfg.d_model % g == 0, f"d_model {cfg.d_model} % {g} != 0"),
        (dq % g == 0, f"n_heads * head_dim {dq} % {g} != 0"),
        (cfg.d_ff % g == 0, f"d_ff {cfg.d_ff} % {g} != 0"),
        (max(cfg.d_model, dq, cfg.d_ff) <= MAX_K,
         f"a contraction dim above {MAX_K}"),
    )
    for ok, why in gates:
        if not ok:
            return f"talker_step: {why}"
    return None


def supported(cfg, batch: int, mode: str = "w4a8") -> bool:
    return unsupported(cfg, batch, mode) is None


def packed_mode(params) -> Optional[str]:
    """The talker-step mode whose packed weights `params` carries under
    "fused_<mode>", named by params["talker_step_mode"]
    (runtime/generate.Generator), or None.  A bare "fused_w4a8" is w4a8.
    (The predictor's own kernel weights sit under "fused_int8", which is
    not a talker-step pack.)"""
    return params.get("talker_step_mode",
                      "w4a8" if "fused_w4a8" in params else None)


def prep_layer_weights(cfg, params, mode: str = "w4a8") -> Dict[str, Any]:
    """Kernel-ready form of the stacked talker layers in weight mode
    `mode`, made once, one layer at a time, on the weights' device, from
    bf16 layers or int8 dicts (ops.quant), with the integers of JAX
    `prep_layer_weights`: f32 norms [L, D] and [L, head_dim] (not tiled),
    and per matrix (output-major: one output column's K values
    contiguous)
    - w4a8: `<m>_q` uint8 [L, N, K/2] (ops.quant.pack_int4) with `<m>_s`
      bf16 [L, N, K/128]; an int8 weight is dequantized in f32 (q * s)
      and quantized again (JAX `qs4`);
    - int8, w8a8: `<m>_q` int8 [L, N, K] with `<m>_s` f32 [L, N]: the
      weight's own integers, or quantize_weight of a bf16 weight;
    - bf16: `<m>_q` bf16(q * s) [L, N, K] with unit `<m>_s` f32 [L, N]."""
    if mode not in MODES:
        raise ValueError(f"talker_step: mode {mode!r} is not one of {MODES}")
    lw = params["layers"]

    def pack(w):
        qs, ss = [], []
        for layer in range(cfg.n_layers):
            wl = take(w, layer)
            if mode == "w4a8":
                q, s = quantize_int4_grouped(dequantize(wl))
                qs.append(pack_int4(q))
                ss.append(s.t().contiguous())
                continue
            qt = wl if is_quantized(wl) else quantize_weight(wl)
            q, s = qt["q"], qt["s"].float()
            if mode == "bf16":
                q = (q.float() * s[None, :]).to(torch.bfloat16)
                s = torch.ones_like(s)
            qs.append(q.t().contiguous())
            ss.append(s.contiguous())
        return torch.stack(qs), torch.stack(ss)

    out = {"ln1": lw["ln1"].float().contiguous(),
           "ln2": lw["ln2"].float().contiguous(),
           "qn": lw["q_norm"].float().contiguous(),
           "kn": lw["k_norm"].float().contiguous()}
    for name, key in (("wqkv", "wqkv"), ("wo", "wo"), ("gu", "w_gate_up"),
                      ("dn", "w_down")):
        out[name + "_q"], out[name + "_s"] = pack(lw[key])
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


def quantize_rows_plain(x: torch.Tensor):
    """Per-row int8 activations (w4a8.cuh quantize_rows, JAX `_qmm4`'s and
    `_qmm(w8a8=True)`'s): x bf16 [B, K] -> (xq [B, K] f32 integers, sx
    [B, 1] f32) with sx = max(amax, 1e-8) * f32(1/127), xq =
    round_half_even(x / sx).  The kernel quantizes each GEMV input once
    (the norm phase, or its producers' running max |x| and the stage):
    amax is a max, the same in any order, so this is its arithmetic."""
    xf = x.float()
    sx = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-8) * INV127
    return torch.round(xf / sx), sx


def qmm4_rows_plain(xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor,
                    ws: torch.Tensor) -> torch.Tensor:
    """qmm4_plain from rows already quantized (quantize_rows_plain)."""
    b, k = xq.shape
    n = wq.shape[0]
    ng = k // INT4_GROUP
    nb = ng // 2
    q = unpack_int4(wq).float().reshape(ng, INT4_GROUP, n)
    d = torch.einsum("bgk,gkn->bgn", xq.reshape(b, ng, INT4_GROUP), q)
    s = ws.float().t()                                   # [ng, N]
    acc = torch.zeros(b, n, dtype=torch.float32, device=xq.device)
    for i in range(nb):
        acc = acc + d[:, i] * s[i]
        acc = acc + d[:, nb + i] * s[nb + i]
    return (acc * sx).to(torch.bfloat16)


def qmm4_plain(x: torch.Tensor, wq: torch.Tensor,
               ws: torch.Tensor) -> torch.Tensor:
    """w4a8 matmul, JAX `_qmm4`: x bf16 [B, K] by packed wq uint8
    [N, K/2] with scales ws bf16 [N, K/128] -> bf16 [B, N].  The group
    dots are integers below 2^24, so the f32 einsum computes them
    exactly, in any order."""
    return qmm4_rows_plain(*quantize_rows_plain(x), wq, ws)


def w4a8_gemv(x: torch.Tensor, wq: torch.Tensor,
              ws: torch.Tensor) -> torch.Tensor:
    """One w4a8 GEMV on the talker step kernel's tensor-core core
    (csrc/gemv_stream.cuh w4a8_tile: mma.sync s8, the group sums in f32 in
    the JAX order), for the checks that hold it alone: x bf16 [B, K], wq
    uint8 [N, K/2], ws bf16 [N, K/128] -> bf16 [B, N], which must equal
    qmm4_plain bit for bit.  The rows are quantized by quantize_rows_plain
    (the kernel's norm phase computes the same integers); on a CPU tensor
    it is qmm4_plain.  Each launch adds one to `w4a8_gemv.launches`."""
    if x.device.type == "cpu":
        return qmm4_plain(x, wq, ws)
    b, k = x.shape
    n = wq.shape[0]
    if (x.dtype != torch.bfloat16 or wq.dtype != torch.uint8
            or ws.dtype != torch.bfloat16 or tuple(wq.shape) != (n, k // 2)
            or tuple(ws.shape) != (n, k // INT4_GROUP) or n % 8
            or k % (2 * INT4_GROUP) or k > MAX_K
            or not (wq.is_contiguous() and ws.is_contiguous())):
        raise ValueError("w4a8_gemv: x bf16 [B, K], wq uint8 [N, K/2], ws "
                         "bf16 [N, K/128], N % 8 == 0, K % 256 == 0")
    from .build import LIBRARY, check
    xq, sx = quantize_rows_plain(x)
    xq = xq.to(torch.int8).contiguous()
    sx = sx[:, 0].contiguous()
    y = torch.empty(b, n, dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = LIBRARY.get().qtts_w4a8_gemv(
            xq.data_ptr(), sx.data_ptr(), wq.data_ptr(), ws.data_ptr(), b, n,
            k, y.data_ptr(), stream)
    check(rc, "w4a8_gemv")
    w4a8_gemv.launches += 1
    return y


w4a8_gemv.launches = 0


def qmm8_plain(x: torch.Tensor, wq: torch.Tensor,
               ws: torch.Tensor) -> torch.Tensor:
    """JAX `_qmm` (int8 and bf16 modes): x bf16 [B, K] by wq (int8 or
    bf16) [N, K] with f32 scales ws [N] -> bf16(bf16(x . w in f32) *
    bf16(s)) [B, N]."""
    y = (x.float() @ wq.float().t()).to(torch.bfloat16)
    return y * ws.to(torch.bfloat16)


def qmm8_lanes_plain(x: torch.Tensor, wq: torch.Tensor,
                     ws: torch.Tensor) -> torch.Tensor:
    """qmm8_plain with its f32 dot summed in the CUDA kernel's order
    (csrc/talker_step.cu q8_gemv_kernel): lane l of the warp that owns a
    column adds, in K order, the 16 products [512 s + 16 l, 512 s + 16 l
    + 16) of each 512-value sweep s; the warp then adds its lanes by a
    butterfly (xor 16, 8, 4, 2, 1).  The products are exact in f32, so
    this is the kernel's arithmetic bit for bit."""
    b, k = x.shape
    n = wq.shape[0]
    prod = x.float()[:, None, :] * wq.float()[None]        # [B, N, K]
    sweeps = -(-k // 512)
    prod = F.pad(prod, (0, sweeps * 512 - k))              # adds exact 0s
    prod = prod.reshape(b, n, sweeps, 32, 16)
    acc = torch.zeros(b, n, 32, dtype=torch.float32, device=x.device)
    for sw in range(sweeps):
        for j in range(16):
            acc = acc + prod[:, :, sw, :, j]
    lanes = torch.arange(32, device=x.device)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lanes ^ o]
    return acc[..., 0].to(torch.bfloat16) * ws.to(torch.bfloat16)


def qmm_a8_plain(x: torch.Tensor, wq: torch.Tensor,
                 ws: torch.Tensor) -> torch.Tensor:
    """JAX `_qmm(w8a8=True)`: x bf16 [B, K] quantized per row, int8
    wq [N, K], f32 ws [N] -> bf16(f32(xq . wq) * sx * s) [B, N].  The
    integer dot is exact in f64 (|sum| < 2^53)."""
    xq, sx = quantize_rows_plain(x)
    acc = (xq.double() @ wq.double().t()).float()
    return (acc * sx * ws.float()).to(torch.bfloat16)


def qmm_plain(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
              mode: str, kernel_order: bool = False) -> torch.Tensor:
    """The weight matmul of mode `mode` (module docstring).  w4a8 and
    w8a8 take exact integer dots, summed as the kernel sums them; the int8
    and bf16 modes' f32 dot is torch's (the JAX `_qmm` reference), or with
    kernel_order=True the CUDA kernel's (qmm8_lanes_plain)."""
    if mode == "w4a8":
        return qmm4_plain(x, wq, ws)
    if mode == "w8a8":
        return qmm_a8_plain(x, wq, ws)
    if kernel_order:
        return qmm8_lanes_plain(x, wq, ws)
    return qmm8_plain(x, wq, ws)


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
                      write_idx, prompt_cap: int,
                      mode: str = "w4a8") -> torch.Tensor:
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
            return qmm_plain(v, w[name + "_q"][layer], w[name + "_s"][layer],
                             mode)

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


def _check(cfg, w, x, cos, sin, cache_k, cache_v, lengths, write_idx,
           mode):
    b, d = x.shape
    why = unsupported(cfg, b, mode)
    if why:
        raise ValueError(why)
    L, dh, hkv = cfg.n_layers, cfg.head_dim, cfg.n_kv_heads
    dq, f = cfg.n_heads * dh, cfg.d_ff
    nqkv = dq + 2 * hkv * dh
    mats = {"wqkv": (nqkv, d), "wo": (d, dq), "gu": (2 * f, d),
            "dn": (d, f)}
    want = {"ln1": ((L, d), torch.float32), "ln2": ((L, d), torch.float32),
            "qn": ((L, dh), torch.float32), "kn": ((L, dh), torch.float32)}
    for name, (n, k) in mats.items():
        if mode == "w4a8":
            want[name + "_q"] = ((L, n, k // 2), torch.uint8)
            want[name + "_s"] = ((L, n, k // INT4_GROUP), torch.bfloat16)
        else:
            qdt = torch.bfloat16 if mode == "bf16" else torch.int8
            want[name + "_q"] = ((L, n, k), qdt)
            want[name + "_s"] = ((L, n), torch.float32)
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
            raise ValueError(f"talker_step ({mode}): {name} must be {dtype} "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"talker_step: {name} must be contiguous and "
                             "16-byte aligned")
        if t.device != x.device:
            raise ValueError("talker_step: all inputs must be on one device")


SPLIT = 64             # prefix slots per attention work item (the kernel's)

# Kernels' kept scratch, per weights dict (so per Generator), under the id
# of one of its tensors and dropped when that tensor is freed.
_KEPT: Dict[int, Dict[Tuple, Any]] = {}


def kept_scratch(owner: torch.Tensor) -> Dict[Tuple, Any]:
    """The dict of scratch kept for the weights that `owner` belongs to."""
    key = id(owner)
    if key not in _KEPT:
        _KEPT[key] = {}
        weakref.finalize(owner, _KEPT.pop, key, None)
    return _KEPT[key]


def step_scratch(cfg, device, batch: int, cap: int,
                 per_lane: bool) -> Dict[str, torch.Tensor]:
    """The kernel's scratch at `batch` lanes and cache capacity `cap`, in
    the order of csrc/talker_step.cu's Args: the activations (qkv, the
    attention context, SwiGLU's ff, the normed rows as bf16 and as int8 with
    their scales), each layer's running max |ctx| and max |ff| per lane,
    the attention's split partials (acc [B * Hkv, ceil(cap / SPLIT), G,
    Dh], then (max, sum) [..., 2]) and arrival counters, the grid barrier's
    two counters (both kinds of counter made zero here; the kernel sets
    them back to zero as it goes) and, per-lane, the k/v token buffers
    [L, B, Hkv, Dh] that append_kv_lanes writes into the cache."""
    bf, f32, i32 = torch.bfloat16, torch.float32, torch.int32
    h, hkv, dh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    b, L = int(batch), cfg.n_layers
    splits = b * hkv * -(-int(cap) // SPLIT) * (h // hkv)
    out = {"qkv": torch.empty(b, (h + 2 * hkv) * dh, dtype=bf, device=device),
           "ctx": torch.empty(b, h * dh, dtype=bf, device=device),
           "ff": torch.empty(b, cfg.d_ff, dtype=bf, device=device),
           "hn": torch.empty(b, d, dtype=bf, device=device),
           "xq": torch.empty(b, d, dtype=torch.int8, device=device),
           "sx": torch.empty(b, dtype=f32, device=device),
           "amax": torch.empty(L, 2, b, dtype=i32, device=device),
           "part": torch.empty(splits * (dh + 2), dtype=f32, device=device),
           "arrive": torch.zeros(b * hkv, dtype=i32, device=device),
           "barrier": torch.zeros(2, dtype=i32, device=device)}
    if per_lane:
        for name in ("k_tok", "v_tok"):
            out[name] = torch.empty(L, b, hkv, dh, dtype=bf, device=device)
    return out


def _scratch(cfg, w, x, cap, per_lane):
    kept = kept_scratch(w["ln1"])
    key = ("step", x.shape[0], cfg.n_layers, int(cap), per_lane, x.device)
    if key not in kept:
        kept[key] = step_scratch(cfg, x.device, x.shape[0], cap, per_lane)
    return kept[key]


def phase_labels(cfg) -> List[str]:
    """The kernel's phases in order (a grid barrier between two): per layer
    "norm1", "qkv", "attn", "wo", "norm2", "gate_up", "down"; 196 at
    TalkerConfig()'s 28 layers."""
    return ["norm1", "qkv", "attn", "wo", "norm2", "gate_up",
            "down"] * cfg.n_layers


def talker_step_fused(cfg, w, x, cos, sin, cache_k, cache_v, lengths,
                      write_idx, prompt_cap: int,
                      uniform_cursor: bool = True,
                      mode: str = "w4a8",
                      clocks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decode step over all layers.

    w: `prep_layer_weights(cfg, params, mode)`; x [B, D] bf16 input
    embedding; cos/sin [B, head_dim] f32 rope rows of each lane's
    position; cache_k/v [L, B, Hkv, C, Dh] bf16, written IN PLACE at
    write_idx; lengths and write_idx [B] int32.  uniform_cursor=False
    stages the k/v rows and appends them with one append_kv_lanes launch
    (module docstring).  Returns the hidden state [B, D] bf16 BEFORE the
    final norm.  Each kernel call (one cooperative launch) adds one to
    `talker_step_fused.launches` and to
    `talker_step_fused.launches_by_mode[mode]`, and leaves its block count
    in `talker_step_fused.grid`.  The kernel's scratch (step_scratch) is
    made at the first call of each shape and kept with the weights `w`.
    `clocks`, an int64 CUDA tensor of len(phase_labels(cfg)) + 1 entries,
    gets block 0's SM clock at the kernel's start, as it leaves each grid
    barrier, and at its end (the phases' lengths, for measurements).
    """
    if x.device.type == "cpu":
        return talker_step_plain(cfg, w, x, cos, sin, cache_k, cache_v,
                                 lengths, write_idx, prompt_cap, mode)
    if x.device.type != "cuda":
        raise ValueError(f"talker_step runs on cuda or cpu, not {x.device}")
    _check(cfg, w, x, cos, sin, cache_k, cache_v, lengths, write_idx, mode)
    if clocks is not None and (
            clocks.dtype != torch.int64 or clocks.device != x.device
            or clocks.numel() != len(phase_labels(cfg)) + 1):
        raise ValueError("talker_step: clocks must be int64 on the inputs' "
                         "device, one entry per phase + 1")
    from .build import LIBRARY, check
    b, d = x.shape
    cap = cache_k.shape[3]
    sc = _scratch(cfg, w, x, cap, not uniform_cursor)
    out = torch.empty_like(x)
    ptrs = [x, out, cos, sin] + [w[k] for k in _WEIGHTS]
    ptrs += [cache_k, cache_v, sc.get("k_tok"), sc.get("v_tok"), lengths,
             write_idx]
    ptrs += [sc[k] for k in ("qkv", "ctx", "ff", "hn", "xq", "sx", "amax",
                             "part", "arrive", "barrier")] + [clocks]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    ints = [cfg.n_layers, b, d, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cap,
            int(prompt_cap), MODES.index(mode), sms]
    flts = [float(cfg.rms_eps), cfg.head_dim ** -0.5]
    c_ptrs = (ctypes.c_void_p * len(ptrs))(
        *[None if t is None else t.data_ptr() for t in ptrs])
    c_ints = (ctypes.c_int * len(ints))(*ints)
    c_flts = (ctypes.c_float * len(flts))(*flts)
    grid = (ctypes.c_int * 1)()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = LIBRARY.get().qtts_talker_step(c_ptrs, len(ptrs), c_ints,
                                            len(ints), c_flts, len(flts),
                                            grid, stream)
    check(rc, f"talker_step_fused ({mode})")
    talker_step_fused.launches += 1
    talker_step_fused.launches_by_mode[mode] += 1
    talker_step_fused.grid = grid[0]
    if not uniform_cursor:
        append_kv_lanes(cache_k, cache_v, sc["k_tok"], sc["v_tok"], write_idx)
    return out


talker_step_fused.launches = 0
talker_step_fused.launches_by_mode = dict.fromkeys(MODES, 0)
talker_step_fused.grid = 0
