"""Weight matmuls of the LMs.  Counterpart of qwen3_tts_tpu/ops/quant.py,
for plain (unquantized, quant="none") weights only: int8 and int4 weights
are not ported yet."""

from __future__ import annotations

import torch


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w. x: [..., in], w: [in, out] -> [..., out] in x.dtype."""
    return torch.matmul(x, w)


def head_matmul(hidden: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """hidden [..., d] @ head.T -> [..., vocab] in f32."""
    return torch.matmul(hidden.float(), head.float().t())


def head_matmul_slice(hidden: torch.Tensor, head: torch.Tensor, start: int,
                      size: int) -> torch.Tensor:
    """hidden [..., d] @ head[start:start+size].T -> [..., size] in f32:
    reads only the needed head rows (one codebook window of the
    predictor's lm-head)."""
    return torch.matmul(hidden.float(), head[start:start + size].float().t())
