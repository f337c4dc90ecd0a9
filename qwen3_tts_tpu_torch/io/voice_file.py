"""Copy of qwen3_tts_tpu/io/voice_file.py: the port cannot import the JAX package,
whose __init__ imports jax.  Keep the two in step.

Voice identity persistence (VoiceFile JSON).

Schema parity with the reference's src/utils/voice_file.rs:5-62: `ref_text`,
`audio_codes` (flattened frames x 16), `speaker_embedding` (accepts the
`spk_emb` alias used by the preset speaker JSONs), plus optional metadata.
Preset speaker files additionally carry `spk_id`, which (as in the reference)
is preserved but synthesis flows through the embedding path.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class VoiceFile:
    ref_text: str = ""
    audio_codes: List[int] = field(default_factory=list)
    speaker_embedding: List[float] = field(default_factory=list)
    name: Optional[str] = None
    gender: Optional[str] = None
    age: Optional[str] = None
    description: Optional[str] = None
    spk_id: Optional[int] = None  # present in preset JSONs; not used at synth

    @staticmethod
    def new(ref_text: str, audio_codes, speaker_embedding) -> "VoiceFile":
        return VoiceFile(
            ref_text=ref_text,
            audio_codes=[int(c) for c in np.asarray(audio_codes).reshape(-1)],
            speaker_embedding=[float(x) for x in np.asarray(speaker_embedding).reshape(-1)],
        )

    def with_metadata(self, name=None, gender=None, age=None, description=None) -> "VoiceFile":
        self.name, self.gender, self.age, self.description = name, gender, age, description
        return self

    @staticmethod
    def load(path) -> "VoiceFile":
        with open(path, "r", encoding="utf-8") as f:
            d = json.load(f)
        emb = d.get("speaker_embedding", d.get("spk_emb", []))
        return VoiceFile(
            ref_text=d.get("ref_text", ""),
            audio_codes=[int(c) for c in d.get("audio_codes", [])],
            speaker_embedding=[float(x) for x in emb],
            name=d.get("name"),
            gender=d.get("gender"),
            age=d.get("age"),
            description=d.get("description"),
            spk_id=d.get("spk_id"),
        )

    def save(self, path) -> None:
        d = {
            "ref_text": self.ref_text,
            "audio_codes": self.audio_codes,
            "speaker_embedding": self.speaker_embedding,
            "name": self.name,
            "gender": self.gender,
            "age": self.age,
            "description": self.description,
        }
        if self.spk_id is not None:
            d["spk_id"] = self.spk_id
        with open(path, "w", encoding="utf-8") as f:
            json.dump(d, f, indent=2)

    @property
    def codes_array(self) -> np.ndarray:
        """Codes as [frames, 16] int32 (drops any trailing partial frame)."""
        flat = np.asarray(self.audio_codes, np.int32)
        n = (len(flat) // 16) * 16
        return flat[:n].reshape(-1, 16)

    @property
    def embedding_array(self) -> np.ndarray:
        return np.asarray(self.speaker_embedding, np.float32)
