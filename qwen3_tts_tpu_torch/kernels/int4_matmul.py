"""x @ packed-int4 weights with grouped scales.

`matmul_int4` is the port of the Pallas kernel of the same name
(qwen3_tts_tpu/kernels/int4_matmul.py), which ops.quant.matmul calls for
int4 weights (`quantize_weight_int4`, `quantize_decoder_layers_int4`).  On
a CUDA tensor it launches `csrc/int4_matmul.cu`; on a CPU tensor it runs
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

from typing import Dict, Optional

import torch

from ..ops.quant import unpack_int4

MAX_K = 8192       # the kernel keeps up to 8 rows of x in shared memory


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


def unsupported(x: torch.Tensor, w4) -> Optional[str]:
    """The first gate of the kernel that these inputs fail, or None."""
    q4, s = w4["q4"], w4["s"]
    if q4.dim() != 2 or s.dim() != 2:
        return "matmul_int4: one 2-D weight at a time"
    n, k = q4.shape[0], 2 * q4.shape[1]
    gates = (
        (q4.dtype == torch.uint8 and s.dtype == torch.float32,
         "q4 must be uint8 and s float32"),
        (x.shape[-1] == k, f"x has {x.shape[-1]} columns, the weight K={k}"),
        (s.shape[0] == n and k % s.shape[1] == 0,
         f"scales {tuple(s.shape)} do not fit the weight [{n}, {k}]"),
        (k % 32 == 0 and k <= MAX_K, f"K={k} not a multiple of 32 up to "
         f"{MAX_K}"),
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
    [..., N].  Each kernel launch adds one to `matmul_int4.launches`."""
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
    y = torch.empty(m, n, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = LIBRARY.get().qtts_int4_matmul(
            xm.data_ptr(), q4.data_ptr(), s.data_ptr(), y.data_ptr(), m, n,
            k, k // s.shape[1], stream)
    check(rc, "matmul_int4")
    matmul_int4.launches += 1
    return y.reshape(*lead, n)


matmul_int4.launches = 0
