"""Embedding-table assets: text table, 16 codec codebook tables, the
2048->1024 projection.  Counterpart of qwen3_tts_tpu/io/assets.py.

Only the development-mode source is ported: deterministic random tables
(`random_init`) or arrays handed in (`from_arrays`, and io/from_jax for
the tests).  Loading `qwen3_assets.gguf` waits for a GGUF reader in the
port.  Token ids are folded modulo the table rows, so the 4096-row dev
table exercises the whole pipeline.  Prompts are assembled on the device
(prompt.assemble), so the JAX package's host (numpy) table mirrors, which
only its materialized prompt builders use, are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import protocol as P


@dataclass
class Assets:
    text_table: torch.Tensor         # [R_text, 2048]
    codec_tables: torch.Tensor       # [16, R_codec, 2048]
    codec_tables_1024: torch.Tensor  # [16, R_codec, 1024] = project(codec)
    proj_w: torch.Tensor             # [1024, 2048] f32 (PyTorch [out, in])
    proj_b: torch.Tensor             # [1024] f32
    tts_pad: torch.Tensor            # [2048] f32 = text row TEXT_AUDIO_MARKER
    text_rows: int
    codec_rows: int

    def pack(self) -> dict:
        """The tensors the generation loop needs."""
        return {
            "codec_tables": self.codec_tables,
            "codec_tables_1024": self.codec_tables_1024,
            "proj_w": self.proj_w,
            "proj_b": self.proj_b,
            "tts_pad": self.tts_pad,
        }

    # -- constructors ------------------------------------------------------
    @staticmethod
    def from_arrays(proj_w, proj_b, text, codecs, dtype=torch.float32,
                    device="cpu") -> "Assets":
        """Tables from arrays (numpy or tensors, any float dtype): the
        1024-d codec tables are projected in f32, tts_pad is the marker
        row of the f32 text table (zeros for a table too short to hold
        it), as in the JAX package."""
        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32)
                                   if not torch.is_tensor(a) else a
                                   ).float().to(device)
        proj_w = f32(proj_w).reshape(-1, P.TALKER_DIM)
        proj_b = f32(proj_b).reshape(-1)
        text = f32(text).reshape(-1, P.TALKER_DIM)
        codecs = f32(codecs)
        if codecs.dim() == 2:
            codecs = codecs.reshape(P.NUM_CODEBOOKS, -1, P.TALKER_DIM)
        tts_pad = (text[P.TEXT_AUDIO_MARKER].clone()
                   if text.shape[0] > P.TEXT_AUDIO_MARKER
                   else torch.zeros(P.TALKER_DIM, device=device))
        codecs_dev = codecs.to(dtype)
        codecs_1024 = torch.einsum("qrd,od->qro", codecs_dev.float(),
                                   proj_w) + proj_b
        return Assets(
            text_table=text.to(dtype), codec_tables=codecs_dev,
            codec_tables_1024=codecs_1024.to(dtype), proj_w=proj_w,
            proj_b=proj_b, tts_pad=tts_pad, text_rows=int(text.shape[0]),
            codec_rows=int(codecs.shape[1]))

    @staticmethod
    def random_init(generator: torch.Generator, text_rows: int = 4096,
                    codec_rows: int = 4096, dtype=torch.float32,
                    scale: float = 0.02) -> "Assets":
        """Deterministic random tables on the generator's device for
        development (the JAX init's shapes and scale, other draws).  The
        1024-d tables are projected from the f32 tables and tts_pad is the
        f32 marker row (folded mod text_rows), as in the JAX package."""
        dev = generator.device

        def rnd(*shape):
            return torch.randn(shape, generator=generator, device=dev) * scale
        text = rnd(text_rows, P.TALKER_DIM)
        codecs = rnd(P.NUM_CODEBOOKS, codec_rows, P.TALKER_DIM)
        proj_w = rnd(P.PREDICTOR_DIM, P.TALKER_DIM)
        proj_b = rnd(P.PREDICTOR_DIM)
        codecs_1024 = torch.einsum("qrd,od->qro", codecs, proj_w) + proj_b
        return Assets(
            text_table=text.to(dtype), codec_tables=codecs.to(dtype),
            codec_tables_1024=codecs_1024.to(dtype), proj_w=proj_w,
            proj_b=proj_b, tts_pad=text[P.TEXT_AUDIO_MARKER % text_rows].clone(),
            text_rows=text_rows, codec_rows=codec_rows)
