"""The predictor's 15 residual codes of one frame, with int8 weights.

`predict_frame_fused` is the port of the Pallas kernel of the same name
(qwen3_tts_tpu/kernels/predictor_frame.py): on a CUDA tensor it makes ONE
call into `csrc/predictor_frame.cu`, which runs the frame's 16 tokens x
all layers on the current stream with no host sync (codes pass from the
argmax to the next embedding gather in device memory); on a CPU tensor it
runs `predict_frame_plain`, the same function in plain PyTorch.  There is
no other route: a CUDA input the kernel does not take raises.

Numerics follow the JAX kernel op for op:
- weights int8 per output column, f32 scales (`prep_predictor_weights`,
  made once); each matmul is bf16(x_bf16 . w in f32) * bf16(scale),
  rounded to bf16 (`_qmm`);
- RMSNorm f32 then bf16; per-head q/k RMSNorm then bf16; rope in f32 at
  position t for token t; bf16 residual; SwiGLU bf16(silu_f32(g)) * u;
- attention of token t over the slots s <= t of a zeroed 16-slot KV,
  scores (q . k) * head_dim**-0.5 in f32, f32 softmax;
- after token t >= 1: final norm, then the int8 window t - 1 (2048 rows)
  of the lm-head, logits = (x . w) * row scale in f32; code t is the
  argmax, lowest index on ties; the next input is tables_1024[t][code].
The JAX kernel's head permutation, segment matrices and tiled norms are
lane-packing workarounds of the TPU and are not carried over.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.quant import is_quantized, quantize_weight
from ..ops.rope import inv_frequencies
from .talker_step import (MAX_GROUP, _rms, _rotate_half, kept_scratch,
                          qmm8_plain)

N_TOKENS = 16          # [hidden, emb(code0), emb(code_1..14)]
WINDOW = 2048          # lm-head rows per codebook window
MAX_BATCH = 32


def unsupported(cfg, batch: int) -> Optional[str]:
    """The first gate `cfg` at `batch` fails, or None.  The JAX gate
    (predictor_frame.supported) plus what the port's kernel needs: q/k
    norm on, contraction dims of whole 64-value blocks (its tensor-core
    tiles), at most MAX_GROUP query heads per kv head."""
    gates = (
        (1 <= batch <= MAX_BATCH, f"batch {batch} outside [1, {MAX_BATCH}]"),
        (cfg.n_residual_codebooks == N_TOKENS - 1,
         f"n_residual_codebooks {cfg.n_residual_codebooks} != 15"),
        (cfg.codebook_size == WINDOW,
         f"codebook_size {cfg.codebook_size} != {WINDOW}"),
        (cfg.d_model % 128 == 0, f"d_model {cfg.d_model} % 128 != 0"),
        (cfg.head_dim in (64, 128), f"head_dim {cfg.head_dim} not 64/128"),
        (cfg.qk_norm, "qk_norm is off"),
        (cfg.n_heads % cfg.n_kv_heads == 0
         and cfg.n_heads // cfg.n_kv_heads <= MAX_GROUP,
         f"n_heads {cfg.n_heads} / n_kv_heads {cfg.n_kv_heads}: group must "
         f"divide and be <= {MAX_GROUP}"),
        (cfg.d_ff % 64 == 0, f"d_ff {cfg.d_ff} % 64 != 0"),
    )
    for ok, why in gates:
        if not ok:
            return f"predictor_frame: {why}"
    return None


def supported(cfg, batch: int) -> bool:
    return unsupported(cfg, batch) is None


def int8_of(w, axis: int):
    """An int8 dict of w: w itself when it is one (int8 engine weights:
    the JAX prep passes them through), else quantize_weight(w, axis)."""
    return w if is_quantized(w) else quantize_weight(w, axis=axis)


def prep_predictor_weights(cfg, params) -> Dict[str, Any]:
    """Kernel-ready int8 form of the predictor from plain or int8-dict
    weights, made once on the weights' device: per matrix `<m>_q` int8 [L, N, K] (output-major) with `<m>_s`
    f32 [L, N]; the lm-head `head_q` int8 [15 * 2048, D] with per-row
    `head_s` f32; f32 norms (q/k norms [L, head_dim], not tiled); and the
    rope rows of the 16 token positions, `cos`/`sin` f32 [16, head_dim],
    computed as the JAX kernel computes them."""
    lw = params["layers"]
    dev = lw["ln1"].device
    out = {"ln1": lw["ln1"].float().contiguous(),
           "ln2": lw["ln2"].float().contiguous(),
           "qn": lw["q_norm"].float().contiguous(),
           "kn": lw["k_norm"].float().contiguous(),
           "fn": params["final_norm"].float().contiguous()}
    for name, key in (("wqkv", "wqkv"), ("wo", "wo"), ("gu", "w_gate_up"),
                      ("dn", "w_down")):
        qt = int8_of(lw[key], axis=-2)
        out[name + "_q"] = qt["q"].transpose(-1, -2).contiguous()
        out[name + "_s"] = qt["s"].float().contiguous()
    qt = int8_of(params["lm_head"], axis=-1)
    out["head_q"], out["head_s"] = qt["q"], qt["s"].float()
    inv = inv_frequencies(cfg.head_dim, cfg.rope_theta)
    ang = np.arange(N_TOKENS, dtype=np.float32)[:, None] * inv[None, :]
    out["cos"] = torch.from_numpy(
        np.concatenate([np.cos(ang), np.cos(ang)], -1)).to(dev)
    out["sin"] = torch.from_numpy(
        np.concatenate([np.sin(ang), np.sin(ang)], -1)).to(dev)
    return out


# ------------------------------------------------------------- plain version
def predict_frame_plain(cfg, w, h1024, code0, tables_1024,
                        taps: Optional[List[torch.Tensor]] = None
                        ) -> torch.Tensor:
    """`predict_frame_fused` in plain PyTorch.  `taps`, when given, gets
    the f32 window logits [B, 2048] of tokens 1..15 appended."""
    b = h1024.shape[0]
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dq, dkv, eps, L = h * dh, hkv * dh, cfg.rms_eps, cfg.n_layers
    dev = h1024.device
    kc = torch.zeros(L, b, hkv, N_TOKENS, dh, dtype=torch.bfloat16,
                     device=dev)
    vc = torch.zeros_like(kc)
    slots = torch.arange(N_TOKENS, device=dev)
    rows = tables_1024.shape[1]
    x = h1024.to(torch.bfloat16)
    codes = [code0.to(torch.int32)]
    for t in range(N_TOKENS):
        cos, sin = w["cos"][t], w["sin"][t]
        for layer in range(L):
            def mm(v, name):
                return qmm8_plain(v, w[name + "_q"][layer],
                                  w[name + "_s"][layer])

            hn = _rms(x, w["ln1"][layer], eps).to(torch.bfloat16)
            qkv = mm(hn, "wqkv")
            q = qkv[:, :dq].reshape(b, h, dh)
            k = qkv[:, dq:dq + dkv].reshape(b, hkv, dh)
            v = qkv[:, dq + dkv:].reshape(b, hkv, dh)
            q = _rms(q, w["qn"][layer], eps).to(torch.bfloat16).float()
            k = _rms(k, w["kn"][layer], eps).to(torch.bfloat16).float()
            q = (q * cos + _rotate_half(q) * sin).to(torch.bfloat16)
            k = (k * cos + _rotate_half(k) * sin).to(torch.bfloat16)
            kc[layer, :, :, t] = k
            vc[layer, :, :, t] = v
            qg = q.float().reshape(b, hkv, h // hkv, dh)
            scores = torch.einsum("bkgd,bksd->bkgs", qg,
                                  kc[layer].float()) * (dh ** -0.5)
            scores = scores.masked_fill(slots > t, float("-inf"))
            p = torch.softmax(scores, dim=-1)
            ctx = torch.einsum("bkgs,bksd->bkgd", p, vc[layer].float())
            x = x + mm(ctx.reshape(b, dq).to(torch.bfloat16), "wo")
            hn2 = _rms(x, w["ln2"][layer], eps).to(torch.bfloat16)
            gu = mm(hn2, "gu")
            f = gu.shape[-1] // 2
            ff = F.silu(gu[:, :f].float()).to(torch.bfloat16) * gu[:, f:]
            x = x + mm(ff, "dn")
        code = codes[0]
        if t >= 1:
            hf = _rms(x, w["fn"], eps).to(torch.bfloat16)
            lo = (t - 1) * WINDOW
            logits = (hf.float() @ w["head_q"][lo:lo + WINDOW].float().t()
                      ) * w["head_s"][lo:lo + WINDOW]
            if taps is not None:
                taps.append(logits)
            code = torch.argmax(logits, dim=-1).to(torch.int32)
            codes.append(code)
        if t < N_TOKENS - 1:
            x = tables_1024[t][code.long().clamp(0, rows - 1)].to(
                torch.bfloat16)
    return torch.stack(codes, dim=1)


# ------------------------------------------------------------------- kernel
_WEIGHTS = ("ln1", "ln2", "qn", "kn", "fn", "wqkv_q", "wqkv_s", "wo_q",
            "wo_s", "gu_q", "gu_s", "dn_q", "dn_s", "head_q", "head_s",
            "cos", "sin")


def _check(cfg, w, h1024, code0, tables):
    b, d = h1024.shape
    why = unsupported(cfg, b)
    if why:
        raise ValueError(why)
    L, h, hkv, dh, f = (cfg.n_layers, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    nqkv = (h + 2 * hkv) * dh
    nv = (N_TOKENS - 1) * WINDOW
    f32, i8 = torch.float32, torch.int8
    want = {"ln1": ((L, d), f32), "ln2": ((L, d), f32),
            "qn": ((L, dh), f32), "kn": ((L, dh), f32), "fn": ((d,), f32),
            "wqkv_q": ((L, nqkv, d), i8), "wqkv_s": ((L, nqkv), f32),
            "wo_q": ((L, d, h * dh), i8), "wo_s": ((L, d), f32),
            "gu_q": ((L, 2 * f, d), i8), "gu_s": ((L, 2 * f), f32),
            "dn_q": ((L, d, f), i8), "dn_s": ((L, d), f32),
            "head_q": ((nv, d), i8), "head_s": ((nv,), f32),
            "cos": ((N_TOKENS, dh), f32), "sin": ((N_TOKENS, dh), f32),
            "code0": ((b,), torch.int32),
            "tables": ((N_TOKENS - 1, tables.shape[1], d), torch.bfloat16)}
    tensors = {k: w[k] for k in _WEIGHTS}
    tensors.update(code0=code0, tables=tables)
    for name, t in tensors.items():
        shape, dtype = want[name]
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"predictor_frame: {name} must be {dtype} "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"predictor_frame: {name} must be contiguous "
                             "and 16-byte aligned")
        if t.device != h1024.device:
            raise ValueError("predictor_frame: all inputs must be on one "
                             "device")


def frame_scratch(cfg, device, batch: int,
                  blocks: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The kernel's scratch at `batch` lanes, in the order of
    csrc/predictor_frame.cu's Args: the window logits [B, 15, 2048] f32
    (kept unless the caller asks for taps), the residual stream, qkv, the
    attention context, SwiGLU's ff, the 16-slot KV [L, B, Hkv, 16, Dh]
    (slot t written at token t, read only at later tokens: never zeroed),
    each block's share of each lane's sum of squares [2, B, blocks], each
    block's best (value, index) per lane [B, blocks], the per-kv-head
    arrival counters and the grid barrier's two counters (both made zero
    here; the kernel sets them back to zero as it goes).  `blocks`: the
    grid's size, one block per SM (the card's SM count by default)."""
    bf, f32, i32 = torch.bfloat16, torch.float32, torch.int32
    b = int(batch)
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if blocks is None:
        blocks = torch.cuda.get_device_properties(
            device).multi_processor_count
    kv = (cfg.n_layers, b, hkv, N_TOKENS, dh)
    return {"logits": torch.empty(b, N_TOKENS - 1, WINDOW, dtype=f32,
                                  device=device),
            "x": torch.empty(b, cfg.d_model, dtype=bf, device=device),
            "qkv": torch.empty(b, (h + 2 * hkv) * dh, dtype=bf,
                               device=device),
            "ctx": torch.empty(b, h * dh, dtype=bf, device=device),
            "ff": torch.empty(b, cfg.d_ff, dtype=bf, device=device),
            "kc": torch.empty(kv, dtype=bf, device=device),
            "vc": torch.empty(kv, dtype=bf, device=device),
            "ssq": torch.empty(2, b, blocks, dtype=f32, device=device),
            "best_v": torch.empty(b, blocks, dtype=f32, device=device),
            "best_i": torch.empty(b, blocks, dtype=i32, device=device),
            "arrive": torch.zeros(hkv, dtype=i32, device=device),
            "barrier": torch.zeros(2, dtype=i32, device=device)}


def phase_labels(cfg) -> List[str]:
    """The kernel's phases in order (a grid barrier between two): per token
    and layer "qkv" (with the attention of each kv head run by the block
    that finishes its columns), "wo", "gate_up", "down"; after tokens
    1..15 "head"; then "finish" (code 15): 400 at PredictorConfig()'s 6
    layers."""
    out = []
    for tok in range(N_TOKENS):
        out += ["qkv", "wo", "gate_up", "down"] * cfg.n_layers
        out += ["head"] if tok else []
    return out + ["finish"]


def predict_frame_fused(cfg, w, h1024, code0, tables_1024,
                        taps: Optional[List[torch.Tensor]] = None,
                        clocks: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Codes of one frame.

    w: `prep_predictor_weights(cfg, params)`; h1024 [B, D] f32 projected
    talker hidden (rounded to bf16 by the kernel); code0 [B] int32;
    tables_1024 [16, R, D] codec tables (tables 0..14 are read, in bf16).
    Returns codes [B, 16] int32; `taps`, when given, gets the f32 window
    logits [B, 2048] of tokens 1..15 appended.  Each kernel call (one
    cooperative launch for all B lanes) adds one to
    `predict_frame_fused.launches` and leaves its block count in
    `predict_frame_fused.grid`.  The kernel's scratch (frame_scratch) is
    made at the first call of each batch size and kept with the weights
    `w`.  `clocks`, an int64 CUDA tensor of len(phase_labels(cfg)) + 1
    entries, gets block 0's SM clock at the kernel's start, as it leaves
    each grid barrier, and at its end (for measurements).
    """
    if h1024.device.type == "cpu":
        return predict_frame_plain(cfg, w, h1024, code0, tables_1024, taps)
    if h1024.device.type != "cuda":
        raise ValueError(f"predictor_frame runs on cuda or cpu, not "
                         f"{h1024.device}")
    code0 = code0.to(torch.int32).contiguous()
    tables = tables_1024[:N_TOKENS - 1].to(torch.bfloat16).contiguous()
    _check(cfg, w, h1024, code0, tables)
    if clocks is not None and (
            clocks.dtype != torch.int64 or clocks.device != h1024.device
            or clocks.numel() != len(phase_labels(cfg)) + 1):
        raise ValueError("predictor_frame: clocks must be int64 on the "
                         "inputs' device, one entry per phase + 1")
    from .build import LIBRARY, check
    b, d = h1024.shape
    dev = h1024.device
    kept = kept_scratch(w["ln1"])
    sc = kept.get(("frame", b, dev))
    if sc is None:
        sc = kept[("frame", b, dev)] = frame_scratch(cfg, dev, b)
    h = h1024.to(torch.float32).contiguous()
    codes = torch.empty(b, N_TOKENS, dtype=torch.int32, device=dev)
    logits = sc["logits"] if taps is None else torch.empty_like(sc["logits"])
    ptrs = [h, code0, codes] + [w[k] for k in _WEIGHTS] + [tables, logits]
    ptrs += [sc[k] for k in ("x", "qkv", "ctx", "ff", "kc", "vc", "ssq",
                             "best_v", "best_i", "arrive", "barrier")]
    ptrs.append(clocks)
    ints = [cfg.n_layers, b, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.d_ff, tables.shape[1], WINDOW, sc["best_v"].shape[1]]
    flts = [float(cfg.rms_eps), cfg.head_dim ** -0.5]
    c_ptrs = (ctypes.c_void_p * len(ptrs))(
        *[None if t is None else t.data_ptr() for t in ptrs])
    c_ints = (ctypes.c_int * len(ints))(*ints)
    c_flts = (ctypes.c_float * len(flts))(*flts)
    grid = (ctypes.c_int * 1)()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = LIBRARY.get().qtts_predictor_frame(c_ptrs, len(ptrs), c_ints,
                                                len(ints), c_flts, len(flts),
                                                grid, stream)
    check(rc, "predict_frame_fused")
    predict_frame_fused.launches += 1
    predict_frame_fused.grid = grid[0]
    if taps is not None:
        taps.extend(logits.unbind(1))
    return codes


predict_frame_fused.launches = 0
predict_frame_fused.grid = 0
