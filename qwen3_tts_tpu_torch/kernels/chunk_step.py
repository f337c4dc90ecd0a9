"""A chunk of whole decode frames in one kernel launch.

`gen_chunk_fused` is the port of the Pallas kernel of the same name
(qwen3_tts_tpu/kernels/chunk_step.py) at the JAX gate's batches: 1, 8 or
16 lanes at n_frames 1-8, 24 or 32 lanes at n_frames <= 4.  Per frame and
lane

  sample code_0 from the carried codec logits (greedy, or the threshold
  sampler of ops.sampling.sample_threshold with a uniform given by the
  caller) -> project the talker hidden 2048 -> 1024 (f32, then bf16) ->
  the predictor's 16 tokens (w4a8 weights with f32 group scales, a 16-slot
  KV zeroed per frame, greedy window argmax, next input
  ctab_pred[t][code_t]) -> feedback = f32 sum of the 16 codec_tables rows
  + tts_pad, then bf16 -> the talker's w4a8 decode step (talker_step's
  weights), writing frame f's k/v IN PLACE at slot write_idx + f (one
  cursor for every lane, as a wave's prefill to one bucket leaves it; the
  prompt lengths are per lane) -> the final norm (kept in f32 as the
  hidden) and the int8 codec head, bf16(h) . bf16(q) x row scale in f32,
  over rows [0, 2160).

On a CUDA tensor it makes ONE cooperative launch of `csrc/chunk_step.cu`:
one lane runs its one-lane kernel, 8-32 lanes its batched body (grid,
block size and shared memory from `plan`); on a CPU tensor it
runs `gen_chunk_plain`, the same function in plain PyTorch.  There is no
other route: a CUDA input the kernel does not take, a plan that does not
fit, or a cooperative launch the card refuses, raises.

The plain version follows the JAX kernel op for op: `_qmm4` for every
predictor and talker matmul (talker_step.qmm4_plain, with the predictor's
f32 scales), RMSNorm and rope as in talker_step, the predictor's attention
over slots s <= t with scores scaled after the dot.  Talker attention runs
in the JAX kernel's order: the cache prefix [0, write_idx) with slot c
visible iff c < length or c >= prompt_cap, in 512-slot tiles with an
online softmax, then the chunk's own frames write_idx .. write_idx + f as
one more merge.  The CUDA kernel computes the same function with the
same roundings to bf16, but its f32 sums run in another order: the
prefix in SPLIT-slot splits spread over the grid and combined in split
order (so the softmax rescales at other points), the heads' dots on the
tensor cores (the body) or on one warp a row (the one-lane kernel), and
the other dot products, norms and feedback sum in its lanes' order.  That is the drift chip_smoke.py and tests/test_torch_cuda.py
hold it to; the talker layer's sums in the kernel's own order are
`_talker_layer_plain(orders=KERNEL_ORDERS)`, the rest of the frame's
`gen_chunk_plain(orders=CHUNK_ORDERS)` (all but the heads).

The JAX kernel packs the predictor's q heads in "c-major" order (q head
j * rep + c of kv head j at position c * n_kv_heads + j; `_head_perm`) and
only then quantizes wo to int4 in groups of 128 input rows: that order
decides which heads share a group scale.  The port keeps the q columns of
wqkv in head order and writes the attention context in the c-major order,
so wo's rows and groups are the JAX kernel's; the segment matrices, tiled
norms and lane rolls of the TPU layout are not carried over.  The codec
head needs no padding to 2176 rows.

At B > 1 lanes every lane computes what it computes in any other batched
launch, bit for bit (no sum mixes lanes, no order depends on B); against
the one-lane kernel its heads differ in the order of their sums.  The
JAX batched forms' bf16 q.k scores and bf16
p for the p.v product (matrix-unit artefacts of the TPU loop) and its bf16
proj_w at b >= 24 (ROADMAP Queue C) are not carried over.  The plain
version runs row-wise at any batch.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.quant import (INT4_GROUP, dequantize, is_quantized, pack_int4,
                         quantize_head, quantize_int4_grouped, take)
from ..ops.rope import inv_frequencies
from ..ops.sampling import sample_threshold
from . import predictor_frame as predictor_kernel
from . import talker_step as talker_kernel
from .talker_step import _rms, _rotate_half, qmm4_plain, qmm_plain

N_TOKENS = 16
WINDOW = 2048
V_CODEC = 2160            # sampled logit range [0, 2160), prompt.rs:5-16
MAX_FRAMES = 8
PREFIX_TILE = 512         # the JAX kernel's KV_CHUNK
SPLIT = 64                # the CUDA kernel's talker prefix split
GROUP = 2                 # query heads per kv head the CUDA kernel takes
NEG_INF = -1e30
PRED_HEAD_DIM = 64        # the kernel's predictor attention
PRED_MAX_KV = 8           # its kv heads: the one-lane kernel's scratch fits


BATCHES = (1, 8, 16, 24, 32)
MAX_FRAMES_WIDE = 4       # frames per launch at 24 and 32 lanes


def unsupported(tcfg, pcfg, batch: int, n_frames: int) -> Optional[str]:
    """The first gate of the chunk kernel that the configs fail at
    (batch, n_frames), or None: the JAX gate (batch 1, 8 or 16; 24 or 32
    at n_frames <= 4) plus what the port's kernel needs."""
    g2 = 2 * INT4_GROUP
    if batch not in BATCHES:
        return f"chunk_step: batch {batch} not in {BATCHES}"
    if batch > 16 and n_frames > MAX_FRAMES_WIDE:
        return (f"chunk_step: batch {batch} takes n_frames <= "
                f"{MAX_FRAMES_WIDE}, not {n_frames}")
    gates = (
        (1 <= n_frames <= MAX_FRAMES,
         f"n_frames {n_frames} outside [1, {MAX_FRAMES}]"),
        (pcfg.d_model % g2 == 0, f"predictor d_model {pcfg.d_model} % {g2}"
                                 " != 0"),
        (pcfg.n_heads * pcfg.head_dim % g2 == 0,
         f"predictor n_heads * head_dim {pcfg.n_heads * pcfg.head_dim} % "
         f"{g2} != 0"),
        (pcfg.d_ff % g2 == 0, f"predictor d_ff {pcfg.d_ff} % {g2} != 0"),
        (pcfg.n_residual_codebooks == N_TOKENS - 1,
         f"n_residual_codebooks {pcfg.n_residual_codebooks} != 15"),
        (pcfg.head_dim == PRED_HEAD_DIM,
         f"predictor head_dim {pcfg.head_dim} != {PRED_HEAD_DIM}"),
        (tcfg.n_heads <= GROUP * tcfg.n_kv_heads
         and pcfg.n_heads <= GROUP * pcfg.n_kv_heads,
         f"query heads per kv head (talker {tcfg.n_heads} / "
         f"{tcfg.n_kv_heads}, predictor {pcfg.n_heads} / "
         f"{pcfg.n_kv_heads}) above {GROUP}"),
        (pcfg.n_kv_heads <= PRED_MAX_KV,
         f"predictor n_kv_heads {pcfg.n_kv_heads} above {PRED_MAX_KV}"),
    )
    why = talker_kernel.unsupported(tcfg, batch) \
        or predictor_kernel.unsupported(pcfg, batch)
    if why:
        return f"chunk_step: {why}"
    for ok, why in gates:
        if not ok:
            return f"chunk_step: {why}"
    return None


def supported(tcfg, pcfg, batch: int, n_frames: int) -> bool:
    return unsupported(tcfg, pcfg, batch, n_frames) is None


def _c_major(h: int, hkv: int) -> List[int]:
    """The q head at each position of the c-major order."""
    rep = h // hkv
    return [(i % hkv) * rep + i // hkv for i in range(h)]


def prep_predictor_w4(pcfg, params) -> Dict[str, Any]:
    """The predictor in the chunk kernel's form, made once from plain or
    int8-dict weights (dequantized in f32 first, as JAX `_pack_w4` does):
    f32 norms (q/k norms [L, head_dim]) and per matrix `<m>_q` uint8
    [L, N, K/2] (ops.quant.pack_int4) with `<m>_s` f32 [L, N, K/128].
    wo's input rows are in the c-major head order (module docstring),
    permuted before the grouping, as in JAX."""
    lw = params["layers"]
    h, hkv, dh = pcfg.n_heads, pcfg.n_kv_heads, pcfg.head_dim
    rows = torch.tensor(np.concatenate(
        [np.arange(dh) + head * dh for head in _c_major(h, hkv)]),
        device=lw["ln1"].device)

    def q4(w, perm=None):
        packed, scales = [], []
        for layer in range(pcfg.n_layers):
            wf = dequantize(take(w, layer))
            if perm is not None:
                wf = wf[perm]
            q, s = quantize_int4_grouped(wf, scale_dtype=torch.float32)
            packed.append(pack_int4(q))
            scales.append(s.t().contiguous())
        return torch.stack(packed), torch.stack(scales)

    out = {"ln1": lw["ln1"].float().contiguous(),
           "ln2": lw["ln2"].float().contiguous(),
           "qn": lw["q_norm"].float().contiguous(),
           "kn": lw["k_norm"].float().contiguous()}
    for name, key, perm in (("wqkv", "wqkv", None), ("wo", "wo", rows),
                            ("gu", "w_gate_up", None),
                            ("dn", "w_down", None)):
        out[name + "_q"], out[name + "_s"] = q4(lw[key], perm)
    return out


def _head_int8(head, rows: Optional[int] = None):
    """(int8 [rows, d], f32 [rows]) of an LM head: its own integers when
    it is an int8 dict (engine weights), else quantize_head."""
    if is_quantized(head):
        return head["q"][:rows], head["s"][:rows].float()
    qt = quantize_head(head[:rows])
    return qt["q"], qt["s"]


def prep_chunk_extras(tcfg, pcfg, talker_params, predictor_params,
                      assets_pack) -> Dict[str, Any]:
    """The kernel's other static inputs, made once: the talker's final
    norm; the codec head as int8 with f32 row scales over rows [0, 2160);
    proj_w [1024, 2048] and proj_b in f32; tts_pad; the predictor's final
    norm; its lm-head as int8 with f32 row scales; its rope rows
    pcos/psin [16, head_dim]; the feedback tables as stored; tables
    0..14 of codec_tables_1024 in bf16.  Plain or int8-dict heads (JAX
    `prep_chunk_extras`)."""
    hq, hs = _head_int8(talker_params["codec_head"], V_CODEC)
    pq, ps = _head_int8(predictor_params["lm_head"])
    dev = hq.device
    inv = inv_frequencies(pcfg.head_dim, pcfg.rope_theta)
    ang = np.arange(N_TOKENS, dtype=np.float32)[:, None] * inv[None, :]
    return {
        "tfn": talker_params["final_norm"].float().contiguous(),
        "chead_q": hq.contiguous(), "chead_s": hs.contiguous(),
        "proj_w": assets_pack["proj_w"].float().contiguous(),
        "proj_b": assets_pack["proj_b"].float().contiguous(),
        "tts_pad": assets_pack["tts_pad"].float().contiguous(),
        "pfn": predictor_params["final_norm"].float().contiguous(),
        "phead_q": pq.contiguous(), "phead_s": ps.contiguous(),
        "pcos": torch.from_numpy(np.concatenate(
            [np.cos(ang), np.cos(ang)], -1)).to(dev),
        "psin": torch.from_numpy(np.concatenate(
            [np.sin(ang), np.sin(ang)], -1)).to(dev),
        "ctab_fb": assets_pack["codec_tables"].contiguous(),
        "ctab_pred": assets_pack["codec_tables_1024"][:N_TOKENS - 1].to(
            torch.bfloat16).contiguous(),
    }


# ------------------------------------------------------------- plain version
def _predict_plain(pcfg, w, ex, px, code0, taps, force=None, orders=()):
    """The predictor phase: px [B, D] bf16, code0 [B] -> codes [B, 16].
    With `force` [B, 16], each next input is taken from force's code where
    the frame's own pick (which it returns) differs.  orders: "norms" its
    RMSNorms and final norm, "qk" its q/k norms, in the CUDA kernel's order
    (_rms_kernel_order)."""
    b = px.shape[0]
    h, hkv, dh = pcfg.n_heads, pcfg.n_kv_heads, pcfg.head_dim
    dq, dkv, eps, L = h * dh, hkv * dh, pcfg.rms_eps, pcfg.n_layers
    dev = px.device
    kc = torch.zeros(L, b, hkv, N_TOKENS, dh, dtype=torch.bfloat16,
                     device=dev)
    vc = torch.zeros_like(kc)
    slots = torch.arange(N_TOKENS, device=dev)
    tables = ex["ctab_pred"]
    x = px
    codes = [code0.to(torch.int32)]

    def norm(v, wt, name, threads):
        if name in orders:
            return _rms_kernel_order(v, wt, eps, threads)
        return _rms(v, wt, eps)
    for t in range(N_TOKENS):
        cos, sin = ex["pcos"][t], ex["psin"][t]
        for layer in range(L):
            def mm(v, name):
                return qmm4_plain(v, w[name + "_q"][layer],
                                  w[name + "_s"][layer])

            hn = norm(x, w["ln1"][layer], "norms", 256).to(torch.bfloat16)
            qkv = mm(hn, "wqkv")
            q = qkv[:, :dq].reshape(b, h, dh)
            k = qkv[:, dq:dq + dkv].reshape(b, hkv, dh)
            v = qkv[:, dq + dkv:].reshape(b, hkv, dh)
            q = norm(q, w["qn"][layer], "qk", dh).to(torch.bfloat16).float()
            k = norm(k, w["kn"][layer], "qk", dh).to(torch.bfloat16).float()
            q = (q * cos + _rotate_half(q) * sin).to(torch.bfloat16)
            k = (k * cos + _rotate_half(k) * sin).to(torch.bfloat16)
            kc[layer, :, :, t] = k
            vc[layer, :, :, t] = v
            qg = q.float().reshape(b, hkv, h // hkv, dh)
            scores = torch.einsum("bkgd,bksd->bkgs", qg,
                                  kc[layer].float()) * (dh ** -0.5)
            scores = scores.masked_fill(slots > t, NEG_INF)
            p = torch.softmax(scores, dim=-1)
            ctx = torch.einsum("bkgs,bksd->bkgd", p, vc[layer].float())
            ctx = ctx.transpose(1, 2).reshape(b, dq)           # c-major
            x = x + mm(ctx.to(torch.bfloat16), "wo")
            hn2 = norm(x, w["ln2"][layer], "norms", 256).to(torch.bfloat16)
            gu = mm(hn2, "gu")
            f = gu.shape[-1] // 2
            ff = F.silu(gu[:, :f].float()).to(torch.bfloat16) * gu[:, f:]
            x = x + mm(ff, "dn")
        if t >= 1:
            hf = norm(x, ex["pfn"], "norms", 256).to(torch.bfloat16)
            lo = (t - 1) * WINDOW
            logits = (hf.float() @ ex["phead_q"][lo:lo + WINDOW].float().t()
                      ) * ex["phead_s"][lo:lo + WINDOW]
            if taps is not None:
                taps.append(logits)
            codes.append(torch.argmax(logits, dim=-1).to(torch.int32))
        if t < N_TOKENS - 1:
            code = codes[t] if force is None else force[:, t]
            x = tables[t][code.long().clamp(0, tables.shape[1] - 1)].to(
                torch.bfloat16)
    return torch.stack(codes, dim=1)


def _chunk_attend_plain(q, kc, vc, lengths, start, f, prompt_cap, tile,
                        kernel_scores=False):
    """q [B, H, Dh] bf16 against one layer's cache [B, Hkv, C, Dh]: the
    prefix [0, start) in `tile`-slot tiles, then the chunk's frames
    start .. start + f (already written) as one more merge.  kernel_scores:
    the q . k dots in the CUDA kernel's order (_scores_kernel_order)."""
    b, h, dh = q.shape
    hkv, cap = kc.shape[1], kc.shape[2]
    qs = q.float().reshape(b, hkv, h // hkv, dh) * (dh ** -0.5)

    def score(kt):
        return (_scores_kernel_order(qs, kt) if kernel_scores
                else torch.einsum("bkgd,bkcd->bkgc", qs, kt.float()))
    m = torch.full((b, hkv, h // hkv, 1), NEG_INF, device=q.device)
    s = torch.zeros_like(m)
    acc = torch.zeros_like(qs)
    lens = lengths.long()[:, None]
    for c0 in range(0, start, tile):
        c1 = min(c0 + tile, cap)
        c = torch.arange(c0, c1, device=q.device)[None, :]
        sb = score(kc[:, :, c0:c1])
        valid = (c < lens) | ((c >= prompt_cap) & (c < start))
        sb = torch.where(valid[:, None, None, :], sb,
                         torch.tensor(NEG_INF, device=q.device))
        mb = torch.maximum(m, sb.amax(dim=-1, keepdim=True))
        pe = torch.exp(sb - mb)
        alpha = torch.exp(m - mb)
        acc = acc * alpha + torch.einsum("bkgc,bkcd->bkgd", pe,
                                         vc[:, :, c0:c1].float())
        s = s * alpha + pe.sum(dim=-1, keepdim=True)
        m = mb
    vn = vc[:, :, start:start + f + 1].float()
    sc = score(kc[:, :, start:start + f + 1])
    m_f = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
    p = torch.exp(sc - m_f)
    alpha = torch.exp(m - m_f)
    acc = acc * alpha + torch.einsum("bkgc,bkcd->bkgd", p, vn)
    s = s * alpha + p.sum(dim=-1, keepdim=True)
    ctx = acc / torch.clamp(s, min=1e-30)
    return ctx.reshape(b, h * dh).to(torch.bfloat16)


# ------------------------------------------------- the CUDA kernel's orders
# The sums of the CUDA chunk kernel's talker layer (csrc/chunk_step.cu on
# common.cuh's and w4a8.cuh's helpers) in its own order, for
# `_talker_layer_plain(orders=...)`: "rms" the layer's two RMSNorms (256
# threads), "qk" the per-head q/k norms (head_dim lanes' order; "<name>-sum"
# / "<name>-inv" swap in only the sum of squares / only 1 / sqrt),
# "softmax" the attention's split, combine and merge sums
# (_attend_kernel_order), "scores" its q . k dots (_scores_kernel_order).
# Every other op of the layer rounds the same on both sides.
# KERNEL_ORDERS is the whole set: with it the plain layer reproduces the
# kernel's residuals bit for bit on the card where torch's orders (cuBLAS's
# dot, the reduction kernel's tree) move them by an int8 unit (ROADMAP
# Queue C #1).
ORDERS = ("rms", "rms-sum", "rms-inv", "qk", "qk-sum", "qk-inv", "softmax",
          "scores")
KERNEL_ORDERS = ("rms", "qk", "softmax", "scores")
# The rest of the chunk kernel's frame, for gen_chunk_plain(orders=...):
# "proj" the projection's f32 dots (_project), "feedback" the feedback's
# sum (_feedback), "norms" the predictor's RMSNorms and both final norms
# (256 threads, _rms_kernel_order); "qk" also takes the predictor's q/k
# norms.  CHUNK_ORDERS is the kernel's whole frame but its heads, whose
# dots the tensor cores sum in an order of their own.
FRAME_ORDERS = ("proj", "feedback", "norms")
CHUNK_ORDERS = KERNEL_ORDERS + FRAME_ORDERS


def _butterfly(v: torch.Tensor) -> torch.Tensor:
    """A warp's xor butterfly over the last axis (n lanes, a power of two:
    xor n / 2, ..., 1): every lane ends with the same sum, in this order."""
    n = v.shape[-1]
    lanes = torch.arange(n, device=v.device)
    o = n // 2
    while o:
        v = v + v[..., lanes ^ o]
        o //= 2
    return v[..., 0]


def _warp_sum(v: torch.Tensor) -> torch.Tensor:
    """common.cuh group_sum over the last axis (a multiple of 32, one
    element per thread): each warp's butterfly, then the warps in order."""
    warps = _butterfly(v.reshape(*v.shape[:-1], v.shape[-1] // 32, 32))
    s = warps[..., 0]
    for i in range(1, warps.shape[-1]):
        s = s + warps[..., i]
    return s


def _rms_kernel_order(x, w, eps, threads, kernel_sum=True, kernel_inv=True):
    """f32 (x * inv) * w, x [..., K], with the kernels' RMSNorm
    (common.cuh group_sum; w4a8.cuh quantize_rows; chunk_step.cu
    talker_qk_warp, whose lane holds dims lane + 32 i: the same order):
    kernel_sum, the sum of squares as thread t of `threads` adds
    x[t + threads * i]^2 for i in order, then _warp_sum (else torch's
    mean); kernel_inv, inv = 1 / sqrt(ss / K + eps) (else torch's rsqrt)."""
    xf = x.float()
    k = xf.shape[-1]
    if kernel_sum:
        part = torch.zeros(*xf.shape[:-1], threads, device=x.device)
        for i in range(k // threads):
            part = part + xf[..., i * threads:(i + 1) * threads] ** 2
        ms = _warp_sum(part) / k
    else:
        ms = (xf * xf).mean(dim=-1)
    inv = 1.0 / torch.sqrt(ms + eps) if kernel_inv else torch.rsqrt(ms + eps)
    return (xf * inv[..., None]) * w.float()


def _fma(a, b, c):
    """f32 fma(a, b, c): a * b + c rounded once to f32, emulated in f64,
    where a * b is exact for the operands here (f32 times bf16 or times a
    softmax weight: at most 48 significant bits); only the f64 rounding of
    the sum can differ from a single rounding, at about 2^-28 odds."""
    return (a.double() * b.double() + c.double()).float()


def _scores_kernel_order(qs, kt):
    """q . k per slot in the CUDA kernel's order (chunk_step.cu
    score_slots): 8 lanes per slot, lane p summing dims 16p .. 16p + 15 in
    order by fma, then the 8 lanes' butterfly (xor 4, 2, 1).  qs [..., G,
    Dh] f32, kt [..., C, Dh] -> [..., G, C] f32."""
    q = qs[..., :, None, :].reshape(*qs.shape[:-1], 1, 8, -1)
    k = kt.float()[..., None, :, :].reshape(*kt.shape[:-2], 1,
                                             kt.shape[-2], 8, -1)
    s = torch.zeros(torch.broadcast_shapes(q.shape, k.shape)[:-1],
                    device=qs.device)
    for i in range(q.shape[-1]):
        s = _fma(q[..., i], k[..., i], s)
    return _butterfly(s)


def _attend_kernel_order(q, kc, vc, lengths, start, f, prompt_cap,
                         kernel_scores=True):
    """_chunk_attend_plain in the CUDA kernel's order (chunk_step.cu
    talker_attn): the prefix [0, start) in SPLIT-slot splits, each with
    its own max m_s, p = exp(s - m_s) (0 where masked), l_s the 32 lanes'
    butterfly of p[j] + p[j + 32] and acc_s = P.V in slot order by fma;
    the splits combined in split order (M = max m_s, w_s = exp(m_s - M),
    l and acc summed term by term by fma); then the chunk's frames
    start .. start + f as one more merge (slots in order, acc by fma).
    The scores are _scores_kernel_order's (kernel_scores) or torch's
    dot."""
    b, h, dh = q.shape
    hkv = kc.shape[1]
    g = h // hkv
    dev = q.device
    qs = q.float().reshape(b, hkv, g, dh) * (dh ** -0.5)

    def score(kt):
        return (_scores_kernel_order(qs, kt) if kernel_scores
                else torch.einsum("bkgd,bkcd->bkgc", qs, kt.float()))

    ns = max(1, -(-start // SPLIT))
    n_pad = ns * SPLIT
    c = torch.arange(n_pad, device=dev)[None]
    valid = (((c < lengths.long()[:, None]) | (c >= prompt_cap))
             & (c < start)).reshape(b, 1, 1, ns, SPLIT)
    kp = torch.zeros(b, hkv, n_pad, dh, device=dev)
    vp = torch.zeros_like(kp)
    kp[:, :, :start] = kc[:, :, :start].float()
    vp[:, :, :start] = vc[:, :, :start].float()
    sc = score(kp).reshape(b, hkv, g, ns, SPLIT)
    neg = torch.tensor(NEG_INF, device=dev)
    m = torch.where(valid, sc, neg).amax(-1)                 # [b, k, g, ns]
    p = torch.where(valid, torch.exp(sc - m[..., None]),
                    torch.zeros((), device=dev))
    l = _butterfly(p[..., :SPLIT // 2] + p[..., SPLIT // 2:])
    vs = vp.reshape(b, hkv, 1, ns, SPLIT, dh)
    acc = torch.zeros(b, hkv, g, ns, dh, device=dev)
    for j in range(SPLIT):
        acc = _fma(p[..., j, None], vs[..., j, :], acc)
    mm = m.amax(-1)                                          # [b, k, g]
    wz = torch.exp(m - mm[..., None])
    ls = torch.zeros_like(mm)
    ac = torch.zeros(b, hkv, g, dh, device=dev)
    for z in range(ns):
        ls = _fma(l[..., z], wz[..., z], ls)
        ac = _fma(acc[..., z, :], wz[..., z, None], ac)
    # the chunk's own frames, always visible
    sn = score(kc[:, :, start:start + f + 1])                # [b, k, g, n]
    mx = torch.maximum(mm, sn.amax(-1))
    alpha = torch.exp(mm - mx)
    ac, ls = ac * alpha[..., None], ls * alpha
    for j in range(f + 1):
        pj = torch.exp(sn[..., j] - mx)
        ac = _fma(pj[..., None], vc[:, :, None, start + j], ac)
        ls = ls + pj
    return (ac / torch.clamp(ls, min=1e-30)[..., None]).reshape(
        b, h * dh).to(torch.bfloat16)


def _talker_layer_plain(cfg, w, layer, x, cos, sin, cache_k, cache_v,
                        lengths, start, f, prompt_cap, tile, mode="w4a8",
                        orders=()):
    """Talker layer `layer` of frame f from the residual x [B, d] bf16:
    its k/v row written at slot start + f, the attention in
    _chunk_attend_plain's order (prefix tiles of `tile` slots; with
    "softmax" in `orders` _attend_kernel_order's splits instead), the
    weight matmuls of talker_step's
    `mode` (w: talker_step.prep_layer_weights of that mode), the int8 and
    bf16 modes' f32 dots in the talker-step kernel's order
    (talker_step.qmm8_lanes_plain).  `orders` (names of ORDERS; () is
    torch's, KERNEL_ORDERS all of the chunk kernel's) swaps the CUDA
    kernel's order in for the sums it names.  Returns the next residual
    (bf16)."""
    unknown = set(orders) - set(ORDERS)
    if unknown:
        raise ValueError(f"unknown orders {sorted(unknown)}; from {ORDERS}")
    b = x.shape[0]
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dq, dkv, eps = h * dh, hkv * dh, cfg.rms_eps
    cos, sin = cos.float()[:, None, :], sin.float()[:, None, :]

    def mm(v, name):
        return qmm_plain(v, w[name + "_q"][layer], w[name + "_s"][layer],
                         mode, kernel_order=True)

    def norm(v, wt, name, threads):
        ks = name in orders or name + "-sum" in orders
        ki = name in orders or name + "-inv" in orders
        if not (ks or ki):
            return _rms(v, wt, eps)
        return _rms_kernel_order(v, wt, eps, threads, ks, ki)

    hn = norm(x, w["ln1"][layer], "rms", 256).to(torch.bfloat16)
    qkv = mm(hn, "wqkv")
    q = qkv[:, :dq].reshape(b, h, dh)
    k = qkv[:, dq:dq + dkv].reshape(b, hkv, dh)
    v = qkv[:, dq + dkv:].reshape(b, hkv, dh)
    q = norm(q, w["qn"][layer], "qk", dh).to(torch.bfloat16).float()
    k = norm(k, w["kn"][layer], "qk", dh).to(torch.bfloat16).float()
    q = (q * cos + _rotate_half(q) * sin).to(torch.bfloat16)
    k = (k * cos + _rotate_half(k) * sin).to(torch.bfloat16)
    cache_k[layer][:, :, start + f] = k
    cache_v[layer][:, :, start + f] = v
    if "softmax" in orders:
        ctx = _attend_kernel_order(q, cache_k[layer], cache_v[layer],
                                   lengths, start, f, prompt_cap,
                                   "scores" in orders)
    else:
        ctx = _chunk_attend_plain(q, cache_k[layer], cache_v[layer], lengths,
                                  start, f, prompt_cap, tile,
                                  "scores" in orders)
    x = x + mm(ctx, "wo")
    hn2 = norm(x, w["ln2"][layer], "rms", 256).to(torch.bfloat16)
    gu = mm(hn2, "gu")
    n = gu.shape[-1] // 2
    ff = F.silu(gu[:, :n].float()).to(torch.bfloat16) * gu[:, n:]
    return x + mm(ff, "dn")


def _talker_plain(cfg, w, x, cos, sin, cache_k, cache_v, lengths, start, f,
                  prompt_cap, tile, xs=None, mode="w4a8", orders=()):
    """The talker's layers for frame f: k/v written at slot start + f.
    xs, when given, gets the residual entering each layer and the last."""
    for layer in range(cfg.n_layers):
        if xs is not None:
            xs.append(x)
        x = _talker_layer_plain(cfg, w, layer, x, cos, sin, cache_k, cache_v,
                                lengths, start, f, prompt_cap, tile, mode,
                                orders)
    if xs is not None:
        xs.append(x)
    return x


def _feedback(tables, codes, tts_pad, kernel_order=False):
    """bf16(sum_q tables[q][codes[:, q]] (f32) + tts_pad); kernel_order:
    the rows added one after the other in q order (the CUDA kernel's
    feedback), else torch's sum."""
    n_q, rows = tables.shape[0], tables.shape[1]
    idx = (torch.arange(n_q, device=codes.device)[None, :] * rows
           + codes.long().clamp(0, rows - 1))
    sel = tables.reshape(n_q * rows, -1)[idx].float()
    if kernel_order:
        fb = sel[:, 0]
        for q in range(1, n_q):
            fb = fb + sel[:, q]
    else:
        fb = sel.sum(dim=1)
    return (fb + tts_pad).to(torch.bfloat16)


def _project(hid, ex, kernel_order=False):
    """bf16(hid . proj_w^T + proj_b), hid [B, D] f32.  kernel_order: each
    dot as the CUDA kernel's warp takes it (lane l adds k = 4 l + 128 j + e
    for j, then e < 4, in order by fma; then the 32 lanes' butterfly), else
    torch's matmul."""
    w = ex["proj_w"]
    if not kernel_order:
        return (hid @ w.t() + ex["proj_b"]).to(torch.bfloat16)
    b, d = hid.shape
    h = hid.float().reshape(b, 1, d // 128, 32, 4)
    wr = w.float().reshape(1, w.shape[0], d // 128, 32, 4)
    part = torch.zeros(b, w.shape[0], 32, device=hid.device)
    for j in range(d // 128):
        for e in range(4):
            part = _fma(h[:, :, j, :, e], wr[:, :, j, :, e], part)
    return (_butterfly(part) + ex["proj_b"]).to(torch.bfloat16)


def gen_chunk_plain(tcfg, pcfg, tw, pw, ex, logits, hidden, cache_k,
                    cache_v, lengths, write_idx, cos, sin, u, sampler,
                    prompt_cap: int,
                    taps: Optional[List[torch.Tensor]] = None,
                    force_codes: Optional[torch.Tensor] = None,
                    prefix_tile: int = PREFIX_TILE,
                    layer_taps: Optional[List[torch.Tensor]] = None,
                    orders=(), frame0: int = 0):
    """`gen_chunk_fused` in plain PyTorch (same arguments and effects,
    layer_taps included).

    Four arguments serve the kernel's checks.  force_codes [B, F, 16]
    int32: the frames go on with these codes (the predictor's next inputs,
    the feedback) where their own picks differ, and the picks are what it
    returns; it holds the plain version on the kernel's path past a near
    tie of two logits.  prefix_tile: the cache prefix's tile (the JAX
    kernel's 512 by default); another tile is an equally valid order of
    the same sums, so the two results differ only by the order drift.
    orders: sums in the CUDA kernel's order, the talker layers' (ORDERS,
    _talker_layer_plain; KERNEL_ORDERS is the kernel's whole talker, its
    prefix in SPLIT-slot splits whatever prefix_tile) and the rest of the
    frame's (FRAME_ORDERS; CHUNK_ORDERS all of them).  frame0: the frames
    are frames frame0, frame0 + 1, ... of a chunk that starts at
    write_idx: frame j is written at slot write_idx + frame0 + j and the
    talker attends the chunk's slots [write_idx, write_idx + frame0 + j]
    last, as the kernel's frame frame0 + j does, so one frame of a longer
    launch runs alone from the state before it in the kernel's order (cos,
    sin and u are the frames' own); 0, the default, is a chunk of its
    own."""
    unknown = set(orders) - set(ORDERS) - set(FRAME_ORDERS)
    if unknown:
        raise ValueError(f"unknown orders {sorted(unknown)}; from "
                         f"{ORDERS + FRAME_ORDERS}")
    layer_orders = tuple(o for o in orders if o in ORDERS)
    n_frames = u.shape[0]
    start = int(write_idx[0])
    if frame0 < 0 or start + frame0 + n_frames > cache_k.shape[3]:
        raise ValueError(f"chunk_step: slots {start + frame0}.."
                         f"{start + frame0 + n_frames} past the cache "
                         f"capacity {cache_k.shape[3]}")
    temperature, top_k, top_p = sampler
    lg, hid = logits.float(), hidden.float()
    codes = []
    for f in range(n_frames):
        code0 = sample_threshold(lg, u[f], temperature, top_k, top_p)
        px = _project(hid, ex, "proj" in orders)
        force = None if force_codes is None else force_codes[:, f]
        fc = _predict_plain(pcfg, pw, ex, px, code0, taps, force, orders)
        x = _feedback(ex["ctab_fb"], fc if force is None else force,
                      ex["tts_pad"], "feedback" in orders)
        xs = None if layer_taps is None else []
        x = _talker_plain(tcfg, tw, x, cos[f], sin[f], cache_k, cache_v,
                          lengths, start, frame0 + f, prompt_cap,
                          prefix_tile, xs, orders=layer_orders)
        if xs is not None:
            layer_taps.append(torch.stack(xs, dim=1))
        hid = (_rms_kernel_order(x, ex["tfn"], tcfg.rms_eps, 256)
               if "norms" in orders else _rms(x, ex["tfn"], tcfg.rms_eps))
        lg = (hid.to(torch.bfloat16).float() @ ex["chead_q"].float().t()
              ) * ex["chead_s"]
        codes.append(fc)
    return torch.stack(codes, dim=1), lg, hid


# ------------------------------------------------------------------- kernel
# argument order of csrc/chunk_step.cu's ChunkArgs (pointers, ints, floats)
_TALKER = ("ln1", "ln2", "qn", "kn", "wqkv_q", "wqkv_s", "wo_q", "wo_s",
           "gu_q", "gu_s", "dn_q", "dn_s")
_EXTRAS = ("tfn", "chead_q", "chead_s", "proj_w", "proj_b", "tts_pad",
           "ctab_fb", "ctab_pred", "pfn", "phead_q", "phead_s", "pcos",
           "psin")
MAX_BLOCKS_PER_SM = 8      # the argmax scratch's slots per lane and SM

# The plan of a batched launch (`plan`; B = 1 runs the one-lane kernel,
# which takes none): csrc/chunk_step.cu's weighted phases in its order, and
# the shared memory it is sized against.
PLAN_KINDS = ("proj", "p_qkv", "p_wo", "p_gate_up", "p_down", "p_head",
              "t_qkv", "t_wo", "t_gate_up", "t_down", "codec_head")
PLAN_BATCHES = tuple(b for b in BATCHES if b > 1)


def block_warps(batch: int) -> int:
    """Warps of the one block an SM at `batch` lanes, by measurement
    (PERF.md §6): 8 (255 registers a thread) at 8 lanes, 16 (128) from 16,
    where more warps share the rows' staging and the predictor's attention
    items."""
    return 8 if batch <= 8 else 16


SMEM_PER_BLOCK = 232448    # 227 KB a block at most (H100)
SMALL_BYTES = 6144         # chunk_step.cu Small
TALK_WARP_BYTES = 2560     # chunk_step.cu TalkWarp (talker attention)
PRED_WARP_BYTES = 5248     # chunk_step.cu PredWarp (predictor attention)


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def _plan_mats(tcfg, pcfg) -> Dict[str, tuple]:
    """{kind: (N, K, R, qcol, scol, stride, lda)} of csrc/chunk_step.cu
    mat_of: output columns (a half for R = 2), contraction, the column's
    bytes in device memory, its scales' bytes, the columns' spacing in the
    ring (weight_ring.cuh) and the bytes of one staged row (0: the
    projection keeps its rows in registers)."""
    d, dp, g = tcfg.d_model, pcfg.d_model, INT4_GROUP
    pnqkv = (pcfg.n_heads + 2 * pcfg.n_kv_heads) * pcfg.head_dim
    nqkv = (tcfg.n_heads + 2 * tcfg.n_kv_heads) * tcfg.head_dim
    pdq, dq = pcfg.n_heads * pcfg.head_dim, tcfg.n_heads * tcfg.head_dim

    def w4(n, k, r, scale_bytes):
        return (n, k, r, k // 2, k // g * scale_bytes, k // 2 + 64, k + 16)

    def head(n, k):
        return (n, k, 1, k, 4, k + 64, 2 * k + 16)
    return {"proj": (dp, d, 1, 4 * d, 0, 4 * d, 0),
            "p_qkv": w4(pnqkv, dp, 1, 4), "p_wo": w4(dp, pdq, 1, 4),
            "p_gate_up": w4(pcfg.d_ff, dp, 2, 4),
            "p_down": w4(dp, pcfg.d_ff, 1, 4), "p_head": head(WINDOW, dp),
            "t_qkv": w4(nqkv, d, 1, 2), "t_wo": w4(d, dq, 1, 2),
            "t_gate_up": w4(tcfg.d_ff, d, 2, 2),
            "t_down": w4(d, tcfg.d_ff, 1, 2), "codec_head": head(V_CODEC, d)}


def plan(tcfg, pcfg, batch: int, sms: int) -> Dict[str, Any]:
    """The launch plan of `gen_chunk_fused` at `batch` lanes (PLAN_BATCHES)
    on a card with `sms` SMs, one block of block_warps(batch) warps an SM.
    Each block owns the contiguous tile range
    [b nt / blocks, (b + 1) nt / blocks) of every weighted phase's nt
    8-column output tiles (gemv_stream.cuh tile_range); its share of the
    largest phase sizes the weight ring.  A second region, the rest of the
    block's shared memory, holds the staged rows of a pass (all lanes,
    else passes of 16 or 8 rows, the widest phases first), the K split's
    dots and the attention scratch.  Returns {"blocks", "warps",
    "mt" (m16 row tiles at full batch), "ring_bytes",
    "region_bytes", "smem_bytes", "phases": {kind: {"tiles", "ranges",
    "ring_bytes", "rows", "row_bytes"}}}.  Raises ValueError naming the
    phase when the ring and the rows cannot fit the shared memory, and for
    a batch outside PLAN_BATCHES."""
    if batch not in PLAN_BATCHES:
        raise ValueError(f"chunk_step: batch {batch} takes no plan: one lane "
                         "runs the one-lane kernel; the body takes "
                         f"{PLAN_BATCHES}")
    warps = block_warps(batch)
    blocks, budget = sms, SMEM_PER_BLOCK
    phases = {}
    for kind, (n, k, r, qcol, scol, stride, lda) in _plan_mats(
            tcfg, pcfg).items():
        nt = n // 8
        ranges = [(i * nt // blocks, (i + 1) * nt // blocks)
                  for i in range(blocks)]
        nc = 8 * max(t1 - t0 for t0, t1 in ranges)
        phases[kind] = {"tiles": nt, "ranges": ranges,
                        "ring_bytes": _align16(r * nc * (stride + scol)),
                        "rows": batch, "lda": lda}
    ring = max(p["ring_bytes"] for p in phases.values())
    attn = warps * max(TALK_WARP_BYTES, PRED_WARP_BYTES)

    def rows_bytes(p):
        return _align16(p["rows"] * p["lda"])

    def refuse(kind, region):
        raise ValueError(
            f"chunk_step: phase {kind} does not fit in shared memory at "
            f"batch {batch}, {warps} warps a block: ring {ring} + rows and "
            f"scratch {region} + {SMALL_BYTES} > {budget} bytes")
    if ring + attn + SMALL_BYTES > budget:
        refuse(max(phases, key=lambda k_: phases[k_]["ring_bytes"]), attn)
    while True:
        region = max(attn, *(rows_bytes(p) for p in phases.values()))
        if ring + region + SMALL_BYTES <= budget:
            break
        kind = max(phases, key=lambda k_: rows_bytes(phases[k_]))
        p = phases[kind]
        if p["rows"] <= 8:
            refuse(kind, region)
        p["rows"] = 16 if p["rows"] > 16 else 8
    for p in phases.values():
        p["row_bytes"] = rows_bytes(p)
        del p["lda"]
    # the rest of the block's shared memory goes to the row region too: the
    # GEMVs split a tile's K range over idle warps where its exact dots fit
    # beside the rows
    region = (budget - ring - SMALL_BYTES) // 16 * 16
    return {"blocks": blocks, "warps": warps, "mt": -(-batch // 16),
            "ring_bytes": ring, "region_bytes": region,
            "smem_bytes": ring + region + SMALL_BYTES, "phases": phases}


def _check(tcfg, pcfg, ex, tensors):
    L, d, h, hkv, dh, f = (tcfg.n_layers, tcfg.d_model, tcfg.n_heads,
                           tcfg.n_kv_heads, tcfg.head_dim, tcfg.d_ff)
    LP, dp, ph, phkv, pdh, pf = (pcfg.n_layers, pcfg.d_model, pcfg.n_heads,
                                 pcfg.n_kv_heads, pcfg.head_dim, pcfg.d_ff)
    nf, b, cap, g = (tensors["u"].shape[0], tensors["u"].shape[1],
                     tensors["cache_k"].shape[3], INT4_GROUP)
    f32, i32, bf, u8, i8 = (torch.float32, torch.int32, torch.bfloat16,
                            torch.uint8, torch.int8)
    rows_fb = ex["ctab_fb"].shape[1]
    want = {
        "logits": ((b, V_CODEC), f32), "hidden": ((b, d), f32),
        "cos": ((nf, b, dh), f32), "sin": ((nf, b, dh), f32),
        "u": ((nf, b), f32), "lengths": ((b,), i32), "write_idx": ((b,), i32),
        "cache_k": ((L, b, hkv, cap, dh), bf),
        "cache_v": ((L, b, hkv, cap, dh), bf),
        "tfn": ((d,), f32), "chead_q": ((V_CODEC, d), i8),
        "chead_s": ((V_CODEC,), f32), "proj_w": ((dp, d), f32),
        "proj_b": ((dp,), f32), "tts_pad": ((d,), f32),
        "ctab_fb": ((N_TOKENS, rows_fb, d), ex["ctab_fb"].dtype),
        "ctab_pred": ((N_TOKENS - 1, ex["ctab_pred"].shape[1], dp), bf),
        "pfn": ((dp,), f32), "phead_q": (((N_TOKENS - 1) * WINDOW, dp), i8),
        "phead_s": (((N_TOKENS - 1) * WINDOW,), f32),
        "pcos": ((N_TOKENS, pdh), f32), "psin": ((N_TOKENS, pdh), f32)}
    for pre, (layers, D, H, HKV, DH, FF, sdt) in (
            ("t_", (L, d, h, hkv, dh, f, bf)),
            ("p_", (LP, dp, ph, phkv, pdh, pf, f32))):
        nqkv, dq = (H + 2 * HKV) * DH, H * DH
        want.update({
            pre + "ln1": ((layers, D), f32), pre + "ln2": ((layers, D), f32),
            pre + "qn": ((layers, DH), f32), pre + "kn": ((layers, DH), f32),
            pre + "wqkv_q": ((layers, nqkv, D // 2), u8),
            pre + "wqkv_s": ((layers, nqkv, D // g), sdt),
            pre + "wo_q": ((layers, D, dq // 2), u8),
            pre + "wo_s": ((layers, D, dq // g), sdt),
            pre + "gu_q": ((layers, 2 * FF, D // 2), u8),
            pre + "gu_s": ((layers, 2 * FF, D // g), sdt),
            pre + "dn_q": ((layers, D, FF // 2), u8),
            pre + "dn_s": ((layers, D, FF // g), sdt)})
    if ex["ctab_fb"].dtype not in (f32, bf):
        raise ValueError("chunk_step: ctab_fb must be f32 or bf16")
    dev = tensors["logits"].device
    for name, (shape, dtype) in want.items():
        t = tensors[name]
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"chunk_step: {name} must be {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"chunk_step: {name} must be contiguous and "
                             "16-byte aligned")
        if t.device != dev:
            raise ValueError("chunk_step: all inputs must be on one device")


def gen_chunk_fused(tcfg, pcfg, tw, pw, ex, logits, hidden, cache_k,
                    cache_v, lengths, write_idx, cos, sin, u, sampler,
                    prompt_cap: int,
                    taps: Optional[List[torch.Tensor]] = None,
                    clocks: Optional[torch.Tensor] = None,
                    scratch: Optional[Dict[str, torch.Tensor]] = None,
                    layer_taps: Optional[List[torch.Tensor]] = None,
                    marks: Optional[torch.Tensor] = None):
    """Run u.shape[0] whole frames of B lanes (B in BATCHES; the gate).

    tw: talker_step.prep_layer_weights; pw: prep_predictor_w4; ex:
    prep_chunk_extras; logits [B, 2160] f32 and hidden [B, 2048] f32 carried
    from the previous frame; cache_k/v [L, B, Hkv, C, Dh] bf16, written IN
    PLACE at slots write_idx .. write_idx + F - 1; lengths and write_idx
    [B] int32 (read on the device; the kernel takes write_idx[0] as every
    lane's cursor: the caller keeps the cursor uniform); cos/sin
    [F, B, head_dim] f32 talker rope rows of each lane's F positions; u
    [F, B] f32 uniforms; sampler (temperature, top_k, top_p).  Returns
    (codes [B, F, 16] int32, logits [B, 2160] f32, hidden [B, 2048] f32).
    `taps`, when given, gets the predictor's f32 window logits [B, 2048]
    appended (15 per frame); without it the kernel stores none.
    `layer_taps`, when given, gets per frame the talker's bf16 residual
    [B, L + 1, 2048]: the row entering each layer (the feedback first) and
    the last layer's output, for checks that hold the kernel layer by
    layer from its own state.  `scratch` (chunk_scratch at this B and
    cache capacity; made for the call when None) is kept by a caller that
    decodes chunk after chunk.  One lane runs the one-lane kernel (as many
    8-warp blocks as are resident); 8-32 lanes the body, on `plan`'s
    cooperative grid (one block an SM), and a plan that does not fit
    raises ValueError.  `clocks`, an int64 CUDA tensor of
    len(phase_labels(...)) + 1 entries, gets block 0's SM clock at the
    kernel's start and as it leaves each grid barrier (the kernel's
    phases, for measurements); `marks` (the body only, B > 1), int64 of 4
    entries a phase, its clock within each phase (0 where a phase has no
    such point): the ring's weights landed, warp 0's GEMV tiles done, the
    work done, the barrier reached.  Each kernel launch
    adds one to `gen_chunk_fused.launches` and leaves its grid (blocks,
    warps a block) in `gen_chunk_fused.grid`."""
    if hidden.device.type == "cpu":
        return gen_chunk_plain(tcfg, pcfg, tw, pw, ex, logits, hidden,
                               cache_k, cache_v, lengths, write_idx, cos,
                               sin, u, sampler, prompt_cap, taps,
                               layer_taps=layer_taps)
    if hidden.device.type != "cuda":
        raise ValueError(f"chunk_step runs on cuda or cpu, not "
                         f"{hidden.device}")
    n_frames = u.shape[0] if u.dim() else 0
    b = hidden.shape[0]
    why = unsupported(tcfg, pcfg, b, n_frames)
    if why:
        raise ValueError(why)
    tensors = dict(logits=logits, hidden=hidden, cos=cos, sin=sin, u=u,
                   lengths=lengths, write_idx=write_idx, cache_k=cache_k,
                   cache_v=cache_v)
    tensors.update({"t_" + k: tw[k] for k in _TALKER})
    tensors.update({"p_" + k: pw[k] for k in _TALKER})
    tensors.update({k: ex[k] for k in _EXTRAS})
    _check(tcfg, pcfg, ex, tensors)
    if clocks is not None and (
            clocks.dtype != torch.int64 or clocks.device != hidden.device
            or clocks.numel() != len(phase_labels(tcfg, pcfg, n_frames)) + 1):
        raise ValueError("chunk_step: clocks must be int64 on the inputs' "
                         "device, one entry per phase + 1")
    if marks is not None and (
            marks.dtype != torch.int64 or marks.device != hidden.device
            or marks.numel() != 4 * len(phase_labels(tcfg, pcfg, n_frames))):
        raise ValueError("chunk_step: marks must be int64 on the inputs' "
                         "device, four entries per phase")
    if marks is not None and b == 1:
        raise ValueError("chunk_step: marks is an output of the batched "
                         "body (B > 1), not of the one-lane kernel")
    dev = hidden.device
    cap = cache_k.shape[3]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    pl = plan(tcfg, pcfg, b, sms) if b > 1 else None
    spec = _scratch_spec(tcfg, pcfg, dev, b, cap)
    if scratch is None:
        scratch = chunk_scratch(tcfg, pcfg, dev, b, cap)
    for name, (shape, dtype) in spec.items():
        t = scratch.get(name)
        if (t is None or tuple(t.shape) != shape or t.dtype != dtype
                or t.device != dev):
            raise ValueError(f"chunk_step: scratch {name} must be {dtype} "
                             f"{shape} on {dev} (chunk_scratch)")
    from .build import LIBRARY, check
    d, h, hkv, dh, ff = (tcfg.d_model, tcfg.n_heads, tcfg.n_kv_heads,
                         tcfg.head_dim, tcfg.d_ff)
    dp, ph, phkv, pdh, pff = (pcfg.d_model, pcfg.n_heads, pcfg.n_kv_heads,
                              pcfg.head_dim, pcfg.d_ff)
    out = dict(
        codes=torch.empty(b, n_frames, N_TOKENS, dtype=torch.int32,
                          device=dev),
        logits_out=torch.empty(b, V_CODEC, dtype=torch.float32, device=dev),
        hidden_out=torch.empty(b, d, dtype=torch.float32, device=dev))
    tap_buf = None if taps is None else torch.empty(
        b, n_frames, N_TOKENS - 1, WINDOW, dtype=torch.float32, device=dev)
    ptrs = [logits, hidden, cos, sin, u, lengths, write_idx]
    ptrs += [tw[k] for k in _TALKER] + [cache_k, cache_v]
    ptrs += [ex[k] for k in _EXTRAS] + [pw[k] for k in _TALKER]
    xtap_buf = None if layer_taps is None else torch.empty(
        b, n_frames, tcfg.n_layers + 1, d, dtype=torch.bfloat16, device=dev)
    ptrs += list(out.values()) + [tap_buf, xtap_buf]
    ptrs += [scratch[k] for k in spec]
    ints = [n_frames, tcfg.n_layers, d, h, hkv, dh, ff, cache_k.shape[3],
            int(prompt_cap), pcfg.n_layers, dp, ph, phkv, pdh, pff,
            ex["ctab_fb"].shape[1], ex["ctab_pred"].shape[1], V_CODEC,
            int(ex["ctab_fb"].dtype == torch.bfloat16),
            sms * MAX_BLOCKS_PER_SM, b]
    ints += ([pl["blocks"], pl["warps"], pl["ring_bytes"], pl["region_bytes"]]
             + [pl["phases"][k]["rows"] for k in PLAN_KINDS]
             if pl is not None else [0] * (4 + len(PLAN_KINDS)))
    temperature, top_k, top_p = sampler
    flts = [tcfg.rms_eps, pcfg.rms_eps, temperature, top_k, top_p,
            dh ** -0.5, pdh ** -0.5]
    c_ptrs = (ctypes.c_void_p * (len(ptrs) + 2))(
        *[None if t is None else t.data_ptr() for t in ptrs],
        clocks.data_ptr() if clocks is not None else None,
        marks.data_ptr() if marks is not None else None)
    c_ints = (ctypes.c_int * len(ints))(*ints)
    c_flts = (ctypes.c_float * len(flts))(*flts)
    grid = (ctypes.c_int * 2)()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = LIBRARY.get().qtts_chunk_step(c_ptrs, len(c_ptrs), c_ints,
                                           len(ints), c_flts, len(flts),
                                           grid, stream)
    check(rc, "gen_chunk_fused")
    gen_chunk_fused.launches += 1
    gen_chunk_fused.grid = (grid[0], grid[1])
    if taps is not None:
        taps.extend(tap_buf.permute(1, 2, 0, 3).reshape(-1, b, WINDOW))
    if layer_taps is not None:
        layer_taps.extend(xtap_buf.unbind(1))
    return out["codes"], out["logits_out"], out["hidden_out"]


gen_chunk_fused.launches = 0
gen_chunk_fused.grid = (0, 0)


def _scratch_spec(tcfg, pcfg, device, batch: int, cap: int
                  ) -> Dict[str, Any]:
    """{name: (shape, dtype)} of the kernel's scratch at `batch` lanes and
    cache capacity `cap`, in the order of csrc/chunk_step.cu's Args: each
    lane's rows one after the other (flat, so batch 1 keeps the one-lane
    shapes); "part" holds the talker attention's split partials (acc
    [B * Hkv, ceil(cap / SPLIT), GROUP, Dh], then (max, sum) [..., 2]);
    "ctx" the talker's and the predictor's attention context; "amax" the
    lanes' max |x| of every unnormed GEMV input of a launch (MAX_FRAMES x
    (32 x predictor layers + 2 x talker layers) x B, zeroed by the
    kernel); "parrive" the predictor's qkv tiles done per kv head."""
    bf, f32, i32 = torch.bfloat16, torch.float32, torch.int32
    h, hkv, dh = tcfg.n_heads, tcfg.n_kv_heads, tcfg.head_dim
    ph, phkv, pdh = pcfg.n_heads, pcfg.n_kv_heads, pcfg.head_dim
    b = int(batch)
    slots = (torch.cuda.get_device_properties(device).multi_processor_count
             * MAX_BLOCKS_PER_SM)
    kv = (b * pcfg.n_layers, phkv, N_TOKENS, pdh)
    splits = b * hkv * -(-int(cap) // SPLIT) * GROUP
    slots_amax = MAX_FRAMES * (2 * N_TOKENS * pcfg.n_layers
                               + 2 * tcfg.n_layers) * b
    return {"x": ((b * tcfg.d_model,), bf),
            "qkv": ((b * (h + 2 * hkv) * dh,), bf),
            "ctx": ((b * max(h * dh, ph * pdh),), bf),
            "ff": ((b * tcfg.d_ff,), bf),
            "px": ((b * pcfg.d_model,), bf),
            "pqkv": ((b * (ph + 2 * phkv) * pdh,), bf),
            "pff": ((b * pcfg.d_ff,), bf),
            "pk": (kv, bf), "pv": (kv, bf),
            "part": ((splits * (dh + 2),), f32), "arrive": ((b * hkv,), i32),
            "amax": ((slots_amax,), i32), "parrive": ((phkv,), i32),
            "best_v": ((b * slots,), f32), "best_i": ((b * slots,), i32),
            "barrier": ((2,), i32)}


def chunk_scratch(tcfg, pcfg, device, batch: int, cap: int
                  ) -> Dict[str, torch.Tensor]:
    """The kernel's scratch at `batch` lanes and cache capacity `cap` on a
    CUDA device, made once and passed to every `gen_chunk_fused` call of
    one stream: the activations, the predictor's 16-slot KV, the talker
    attention's split partials and arrival counters, the lanes' max |x|
    slots, the predictor's arrival counters, the argmax slots (one per
    lane and block) and the grid barrier's two counters (the counters made
    zero here; the kernel sets them back to zero as it leaves each phase
    and launch)."""
    device = torch.device(device)
    out = {name: torch.empty(shape, dtype=dtype, device=device)
           for name, (shape, dtype) in _scratch_spec(tcfg, pcfg, device,
                                                     batch, cap).items()}
    out["barrier"].zero_()
    out["arrive"].zero_()
    out["parrive"].zero_()
    return out


def phase_labels(tcfg, pcfg, n_frames: int) -> List[str]:
    """The kernel's phases in launch order (one grid barrier after each):
    per frame "sample+project", per predictor token and layer "p_qkv",
    "p_wo" (the attention and wo in one phase), "p_gate_up", "p_down" and
    after tokens 1..15 "p_head", then "feedback", per talker layer "t_qkv",
    "t_attn", "t_wo", "t_gate_up", "t_down", and "codec_head": 542 per
    frame at EngineConfig()'s depths."""
    frame = ["sample+project"]
    for tok in range(N_TOKENS):
        frame += ["p_qkv", "p_wo", "p_gate_up", "p_down"] * pcfg.n_layers
        frame += ["p_head"] if tok else []
    frame += ["feedback"] + ["t_qkv", "t_attn", "t_wo", "t_gate_up",
                             "t_down"] * tcfg.n_layers
    return (frame + ["codec_head"]) * n_frames


def sample_fused(logits, u, temperature: float, top_k: int,
                 top_p: float) -> torch.Tensor:
    """The chunk kernel's sampler alone (the device function that
    `gen_chunk_fused` runs in its block 0), one block per row: logits
    [B, V] f32, u [B] f32 -> codes [B] int32.  On a CPU tensor it runs
    ops.sampling.sample_threshold.  Used by the tests and chip_smoke.py;
    the decode path reaches the sampler only inside the chunk kernel."""
    if logits.device.type == "cpu":
        return sample_threshold(logits, u, temperature, top_k, top_p)
    if logits.device.type != "cuda":
        raise ValueError(f"sample_fused runs on cuda or cpu, not "
                         f"{logits.device}")
    b, v = logits.shape
    if (logits.dtype != torch.float32 or u.dtype != torch.float32
            or tuple(u.shape) != (b,) or not logits.is_contiguous()
            or not u.is_contiguous() or u.device != logits.device
            or not 0 < v <= 4096):
        raise ValueError("sample_fused: logits [B, V <= 4096] f32 and u [B] "
                         "f32, contiguous, on one device")
    from .build import LIBRARY, check
    out = torch.empty(b, dtype=torch.int32, device=logits.device)
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        rc = LIBRARY.get().qtts_sample_threshold(
            logits.data_ptr(), u.data_ptr(), out.data_ptr(), b, v,
            float(temperature), float(top_k), float(top_p), stream)
    check(rc, "sample_fused")
    return out
