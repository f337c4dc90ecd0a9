"""Process-wide settings of the card that the port's numerics rely on."""

from __future__ import annotations

import torch


def set_cuda_precision() -> None:
    """f32 matmuls and convolutions on the card in full f32: no TF32.
    The JAX package computes the projection, the heads and the codec's
    convolutions with f32 accumulation of f32 (or bf16-exact) inputs;
    cuDNN would otherwise run the codec's f32 convolutions in TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
