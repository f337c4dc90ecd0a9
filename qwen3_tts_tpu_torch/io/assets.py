"""Embedding-table assets: text table, 16 codec codebook tables, the
2048->1024 projection.  Counterpart of qwen3_tts_tpu/io/assets.py.

Sources, in the JAX package's order (`load`): a model directory's
`qwen3_assets.gguf` (`from_gguf`: `proj.weight`, `proj.bias`,
`text_embd`, `codec_embd.<i>`, read with io.gguf), else its legacy NPY
files (`from_npy`: `proj_weight.npy`, `proj_bias.npy`,
`text_embedding_projected.npy`, `codec_embedding_<i>.npy`); also
deterministic random tables for development (`random_init`), or arrays
handed in (`from_arrays`, and io/from_jax for the tests).  The tables live
in the dtype the caller gives (the engine: the talker's compute dtype),
the projection in f32, as in the JAX package.  Token ids are folded
modulo the table rows, so the 4096-row dev table exercises the whole
pipeline.

Requests assemble their prompts on the device (prompt.assemble).  The
host (numpy) lookups (`text_emb_np`, `codec_emb_np`, `frame_emb_sum_np`)
serve the materialized prompt builders (PromptBuilder.build_*, tests and
tools): they read f32 numpy mirrors of the tables, kept from the source
arrays by `from_arrays` (so nothing is read back off the device) and made
from the device tables by `host_tables` only where none was kept.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional

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
    # f32 numpy mirrors of text_table and codec_tables for the host lookups
    # (module docstring); None until host_tables() makes them
    _host_text: Optional[np.ndarray] = None
    _host_codec: Optional[np.ndarray] = None

    def host_tables(self):
        """(text [R_text, 2048], codec [16, R_codec, 2048]) f32 numpy: the
        mirrors kept from the source arrays, else copies of the device
        tables made once."""
        if self._host_text is None:
            self._host_text = self.text_table.float().cpu().numpy()
            self._host_codec = self.codec_tables.float().cpu().numpy()
        return self._host_text, self._host_codec

    # -- host-side lookups (prompt building) ------------------------------
    def text_emb_np(self, ids) -> np.ndarray:
        text, _ = self.host_tables()
        ids = np.asarray(ids, np.int64) % self.text_rows
        return text[ids]

    def codec_emb_np(self, q: int, codes) -> np.ndarray:
        _, codec = self.host_tables()
        codes = np.asarray(codes, np.int64)
        safe = np.clip(codes, 0, self.codec_rows - 1)
        emb = codec[q][safe]
        ok = ((codes >= 0) & (codes < self.codec_rows))[..., None]
        return np.where(ok, emb, 0.0).astype(np.float32)

    def frame_emb_sum_np(self, frames) -> np.ndarray:
        _, codec = self.host_tables()
        frames = np.asarray(frames, np.int64)
        safe = np.clip(frames, 0, self.codec_rows - 1)
        out = np.zeros(frames.shape[:-1] + (codec.shape[-1],), np.float32)
        for q in range(codec.shape[0]):
            ok = ((frames[..., q] >= 0)
                  & (frames[..., q] < self.codec_rows))[..., None]
            out += np.where(ok, codec[q][safe[..., q]], 0.0)
        return out

    # -- lookups on the device tables -------------------------------------
    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(ids, device=self.text_table.device).long()

    def text_emb(self, ids) -> torch.Tensor:
        """Rows of the text table; ids folded mod text_rows (dev tables)."""
        return self.text_table[self._ids(ids) % self.text_rows]

    def codec_emb(self, q: int, codes) -> torch.Tensor:
        """Rows of codec table q; out-of-range codes give zeros."""
        codes = self._ids(codes)
        emb = self.codec_tables[q][codes.clamp(0, self.codec_rows - 1)]
        ok = ((codes >= 0) & (codes < self.codec_rows))[..., None]
        return torch.where(ok, emb, torch.zeros_like(emb))

    def frame_emb_sum(self, codes) -> torch.Tensor:
        """Sum of the 16 per-codebook embeddings for frames [..., 16]."""
        codes = self._ids(codes)
        safe = codes.clamp(0, self.codec_rows - 1)
        gathered = torch.stack(
            [self.codec_tables[q][safe[..., q]]
             for q in range(self.codec_tables.shape[0])], dim=-2)
        ok = ((codes >= 0) & (codes < self.codec_rows))[..., None]
        return torch.where(ok, gathered, torch.zeros_like(gathered)).sum(-2)

    def project(self, hidden) -> torch.Tensor:
        """2048 -> 1024 projection (proj.weight @ h + bias), in f32."""
        h = torch.as_tensor(hidden, device=self.proj_w.device).float()
        return h @ self.proj_w.t() + self.proj_b

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
    def load(model_dir, dtype=torch.float32, device="cpu") -> "Assets":
        """The tables of `<model_dir>/qwen3_assets.gguf`, else of its NPY
        files (`proj_weight.npy` and the rest); FileNotFoundError with
        neither."""
        model_dir = Path(model_dir)
        path = model_dir / "qwen3_assets.gguf"
        if path.exists():
            return Assets.from_gguf(path, dtype, device)
        if (model_dir / "proj_weight.npy").exists():
            return Assets.from_npy(model_dir, dtype, device)
        raise FileNotFoundError(
            f"no qwen3_assets.gguf or proj_weight.npy under {model_dir}")

    @staticmethod
    def from_gguf(path, dtype=torch.float32, device="cpu") -> "Assets":
        from .gguf import read_gguf
        g = read_gguf(path)
        codecs = [g.read_tensor(f"codec_embd.{i}")
                  for i in range(P.NUM_CODEBOOKS)
                  if f"codec_embd.{i}" in g.tensors]
        return Assets.from_arrays(
            g.read_tensor("proj.weight"), g.read_tensor("proj.bias"),
            g.read_tensor("text_embd"), np.stack(codecs), dtype, device)

    @staticmethod
    def from_npy(model_dir, dtype=torch.float32, device="cpu") -> "Assets":
        """The tables of a directory of legacy NPY files."""
        model_dir = Path(model_dir)
        codecs = np.stack([np.load(model_dir / f"codec_embedding_{i}.npy")
                           for i in range(P.NUM_CODEBOOKS)])
        return Assets.from_arrays(
            np.load(model_dir / "proj_weight.npy"),
            np.load(model_dir / "proj_bias.npy"),
            np.load(model_dir / "text_embedding_projected.npy"), codecs,
            dtype, device)

    @staticmethod
    def from_arrays(proj_w, proj_b, text, codecs, dtype=torch.float32,
                    device="cpu") -> "Assets":
        """Tables from arrays (numpy or tensors, any float dtype): the
        1024-d codec tables are projected in f32, tts_pad is the marker
        row of the f32 text table (zeros for a table too short to hold
        it), as in the JAX package.  Numpy text and codec arrays are kept
        as the host mirrors (f32)."""
        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32)
                                   if not torch.is_tensor(a) else a
                                   ).float().to(device)
        host_text = (None if torch.is_tensor(text) else
                     np.asarray(text, np.float32).reshape(-1, P.TALKER_DIM))
        host_codec = None
        if not torch.is_tensor(codecs):
            host_codec = np.asarray(codecs, np.float32)
            if host_codec.ndim == 2:
                host_codec = host_codec.reshape(P.NUM_CODEBOOKS, -1,
                                                P.TALKER_DIM)
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
        mirrors = ({} if host_text is None or host_codec is None else
                   {"_host_text": host_text, "_host_codec": host_codec})
        return Assets(
            text_table=text.to(dtype), codec_tables=codecs_dev,
            codec_tables_1024=codecs_1024.to(dtype), proj_w=proj_w,
            proj_b=proj_b, tts_pad=tts_pad, text_rows=int(text.shape[0]),
            codec_rows=int(codecs.shape[1]), **mirrors)

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
