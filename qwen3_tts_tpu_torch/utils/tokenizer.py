"""Copy of qwen3_tts_tpu/utils/tokenizer.py: the port cannot import the JAX package,
whose __init__ imports jax.  Keep the two in step.

Tokenizer wrapper: HF `tokenizers` when tokenizer.json is present, with a
deterministic hashing fallback for development without model files.

Parity: the reference's src/utils/tokenizer.rs (loads
<model_dir>/tokenizer/tokenizer.json, encode without special tokens).
"""

from __future__ import annotations

from pathlib import Path
from typing import List


class Tokenizer:
    def __init__(self, inner=None, fallback_vocab: int = 50_000):
        self._inner = inner
        self._fallback_vocab = fallback_vocab

    @staticmethod
    def load(model_dir) -> "Tokenizer":
        """Load <model_dir>/tokenizer/tokenizer.json (or tokenizer.json at the
        dir root).  Falls back to the hashing tokenizer if absent."""
        model_dir = Path(model_dir)
        for cand in (model_dir / "tokenizer" / "tokenizer.json",
                     model_dir / "tokenizer.json"):
            if cand.exists():
                from tokenizers import Tokenizer as HFTokenizer
                return Tokenizer(inner=HFTokenizer.from_file(str(cand)))
        return Tokenizer()

    @property
    def is_fallback(self) -> bool:
        return self._inner is None

    def encode(self, text: str) -> List[int]:
        if self._inner is not None:
            return list(self._inner.encode(text, add_special_tokens=False).ids)
        # Deterministic per-character hashing: stable, reversible enough for
        # tests (round-trip not required by the pipeline).
        return [(ord(c) * 2654435761) % self._fallback_vocab for c in text]

    def decode(self, ids) -> str:
        if self._inner is not None:
            return self._inner.decode(list(ids), skip_special_tokens=False)
        return "".join(chr((i % 94) + 33) for i in ids)
