"""x @ packed-int4 weights with grouped scales.

`matmul_int4` is the port of the Pallas kernel of the same name
(qwen3_tts_tpu/kernels/int4_matmul.py), which ops.quant.matmul calls for
int4 weights (`quantize_weight_int4`, `quantize_decoder_layers_int4`).  On
a CUDA tensor it launches one of the two kernels of
`csrc/int4_matmul.cu` (`plan`: the CUDA-core kernel below TILE_MIN_M rows,
the tensor-core tile kernel from there on, with K split where the output
tiles are too few for the card); on a CPU tensor it runs
`matmul_int4_plain`, the same function in plain PyTorch.  There is no
other route: the JAX function's XLA fallback (off the TPU, or for shapes
its kernel does not tile) is not ported, and a CUDA input outside the
kernel's gate raises.

Weights are the port's int4 dict {"q4": uint8 [N, K/2], "s": f32
[N, K/G]} (ops.quant: output-major, pack_int4's nibble order;
io/from_jax.int4_from_jax converts the JAX package's interleaved layout).
Numerics are the JAX kernel's: each weight is dequantized as
bf16(bf16(q) * bf16(s)), x is taken in bf16, and the products are summed
in f32; the output is f32 [..., N].
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..ops.quant import unpack_int4

MAX_K = 8192       # the small-M kernel keeps its rows of x in shared
                   # memory; the tile kernel streams K and takes any K
# From this many rows of x on, the tensor-core tile kernel.  On one H100
# 80GB HBM3 at 700 W, in CUDA graphs on the talker's four weight shapes
# (scripts/torch_int4_sweep.py --crossover 2,3,4): at M = 2 the small-M
# kernel took 17-40 % less time on all four; at M = 4 the tile kernel took
# 7 % and 12 % less on 2048x4096 and 6144x2048 and at most 1.3 % more on
# 2048x2048 and 2048x12288.  The small-M kernel has row instances 1, 2
# and 4 and takes no more than 4 rows.
TILE_MIN_M = 4
TILE_N, TILE_K = 64, 64   # csrc/int4_matmul.cu tile::BN, tile::BK
# mi -> (per_sm, min_steps): K is split until the CTAs reach per_sm per SM,
# keeping at least min_steps 64-row K steps per split.  On the same card
# (scripts/torch_int4_sweep.py --stages 4 --ms 4,8,16,32,64,128) this plan
# was within 5 % of the fastest split at every M measured on all four
# shapes (at M = 32 on 2048x12288: 2 splits, the fastest).
SPLIT_RULE = {1: (3, 4), 2: (3, 4), 4: (2, 8)}


def _dequant_bf16(w4: Dict[str, torch.Tensor]) -> torch.Tensor:
    """bf16(bf16(q) * bf16(s)) [K, N] of one int4 weight."""
    q = unpack_int4(w4["q4"])                              # int8 [K, N]
    s = w4["s"].to(torch.bfloat16).t()                     # [K/G, N]
    g = q.shape[0] // s.shape[0]
    return q.to(torch.bfloat16) * s.repeat_interleave(g, dim=0)


def matmul_int4_plain(x: torch.Tensor,
                      w4: Dict[str, torch.Tensor]) -> torch.Tensor:
    """`matmul_int4` in plain PyTorch: bf16(x) [..., K] @ the bf16
    dequantized weight, in f32 -> f32 [..., N]."""
    return x.to(torch.bfloat16).float() @ _dequant_bf16(w4).float()


def tile_plan(m: int, n: int, k: int, sms: int) -> Tuple[int, int]:
    """(mi, splits) of the tile kernel at m rows on a card of `sms` SMs:
    mi m16 tiles per warp (BM = 32 * mi rows per CTA), its K steps split
    into `splits` ranges (SPLIT_RULE)."""
    mi = 1 if m <= 32 else 2 if m <= 64 else 4
    per_sm, min_steps = SPLIT_RULE[mi]
    tiles = math.ceil(n / TILE_N) * math.ceil(m / (32 * mi))
    steps = math.ceil(k / TILE_K)
    return mi, max(1, min(per_sm * sms // tiles, steps // min_steps))


def plan(m: int, n: int, k: int, sms: int) -> Tuple[int, int]:
    """(mi, splits) of one launch: (0, 0) for the small-M kernel (m below
    TILE_MIN_M), else the tile kernel's tile_plan."""
    return (0, 0) if m < TILE_MIN_M else tile_plan(m, n, k, sms)


def unsupported(x: torch.Tensor, w4) -> Optional[str]:
    """The first gate of the kernel that these inputs take (plan) fails,
    or None."""
    q4, s = w4["q4"], w4["s"]
    if q4.dim() != 2 or s.dim() != 2:
        return "matmul_int4: one 2-D weight at a time"
    n, k = q4.shape[0], 2 * q4.shape[1]
    m = x.numel() // max(1, x.shape[-1])
    gates = (
        (q4.dtype == torch.uint8 and s.dtype == torch.float32,
         "q4 must be uint8 and s float32"),
        (x.shape[-1] == k, f"x has {x.shape[-1]} columns, the weight K={k}"),
        (s.shape[0] == n and k % s.shape[1] == 0,
         f"scales {tuple(s.shape)} do not fit the weight [{n}, {k}]"),
        (k % 32 == 0, f"K={k} not a multiple of 32"),
        (k <= MAX_K or m >= TILE_MIN_M, f"K={k} above {MAX_K} at M={m} "
         f"(below {TILE_MIN_M} rows x sits in shared memory)"),
        (s.shape[1] > 0 and (k // s.shape[1]) % 32 == 0,
         "the group size is not a multiple of 32"),
    )
    for ok, why in gates:
        if not ok:
            return f"matmul_int4: {why}"
    return None


def matmul_int4(x: torch.Tensor, w4: Dict[str, torch.Tensor]
                ) -> torch.Tensor:
    """x [..., K] @ an int4 weight {q4 [N, K/2], s [N, K/G]} -> f32
    [..., N].  Each call that launches the kernels adds one to
    `matmul_int4.launches`; a call on the tile kernel also adds one to
    `.tile_launches`, and one that splits K, whose launch adds the
    partials by a second kernel (int4_splitk_sum), to `.splitk_launches`."""
    if x.device.type == "cpu":
        return matmul_int4_plain(x, w4)
    if x.device.type != "cuda":
        raise ValueError(f"matmul_int4 runs on cuda or cpu, not {x.device}")
    why = unsupported(x, w4)
    if why:
        raise ValueError(why)
    q4, s = w4["q4"], w4["s"]
    for name, t in (("q4", q4), ("s", s)):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"matmul_int4: {name} must be contiguous, "
                             "16-byte aligned, on x's device")
    from .build import LIBRARY, check
    n, k = q4.shape[0], 2 * q4.shape[1]
    lead = x.shape[:-1]
    xm = x.reshape(-1, k).to(torch.bfloat16).contiguous()
    if xm.data_ptr() % 16:
        xm = xm.clone()
    m = xm.shape[0]
    g = k // s.shape[1]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    mi, splits = plan(m, n, k, sms)
    y = torch.empty(m, n, dtype=torch.float32, device=x.device)
    ws = (torch.empty(splits, m, n, dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        lib = LIBRARY.get()
        if mi == 0:
            rc = lib.qtts_int4_matmul(xm.data_ptr(), q4.data_ptr(),
                                      s.data_ptr(), y.data_ptr(), m, n, k, g,
                                      stream)
        else:
            rc = lib.qtts_int4_matmul_tile(
                xm.data_ptr(), q4.data_ptr(), s.data_ptr(), y.data_ptr(),
                0 if ws is None else ws.data_ptr(), m, n, k, g, mi, splits,
                stream)
    check(rc, "matmul_int4")
    matmul_int4.launches += 1
    matmul_int4.tile_launches += mi > 0
    matmul_int4.splitk_launches += splits > 1
    return y.reshape(*lead, n)


matmul_int4.launches = 0
matmul_int4.tile_launches = 0
matmul_int4.splitk_launches = 0
