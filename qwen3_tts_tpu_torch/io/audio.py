"""Copy of qwen3_tts_tpu/io/audio.py: the port cannot import the JAX package,
whose __init__ imports jax.  Keep the two in step.

WAV I/O and the AudioSample container.

Matches the reference semantics (the reference's src/utils/audio.rs and the
richer WAV handling in engine.rs:337-373): loads PCM16/PCM32/FLOAT32 WAVs to
float32 in [-1, 1], takes channel 0 of multi-channel files when requested, and
saves 16-bit PCM with clamping.  Uses the stdlib `wave` module plus numpy —
no external audio dependency.
"""

from __future__ import annotations

import wave
from dataclasses import dataclass

import numpy as np


@dataclass
class AudioSample:
    samples: np.ndarray          # float32 [n] (interleaved if channels > 1)
    sample_rate: int = 24000
    channels: int = 1

    @staticmethod
    def load_wav(path) -> "AudioSample":
        with wave.open(str(path), "rb") as w:
            n_channels = w.getnchannels()
            sampwidth = w.getsampwidth()
            rate = w.getframerate()
            raw = w.readframes(w.getnframes())
        samples = _decode_pcm(raw, sampwidth)
        return AudioSample(samples=samples, sample_rate=rate, channels=n_channels)

    def save_wav(self, path) -> None:
        clamped = np.clip(np.rint(self.samples * 32767.0),
                          -32768, 32767).astype(np.int16)
        with wave.open(str(path), "wb") as w:
            w.setnchannels(self.channels)
            w.setsampwidth(2)
            w.setframerate(self.sample_rate)
            w.writeframes(clamped.tobytes())

    def duration(self) -> float:
        n = len(self.samples) // max(self.channels, 1)
        return n / float(self.sample_rate)

    def mono(self) -> np.ndarray:
        """Channel 0 as float32 (reference takes channel 0 of stereo input)."""
        if self.channels <= 1:
            return np.asarray(self.samples, np.float32)
        return np.asarray(self.samples, np.float32)[:: self.channels]


def _decode_pcm(raw: bytes, sampwidth: int) -> np.ndarray:
    if sampwidth == 2:
        return np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    if sampwidth == 4:
        # WAVE_FORMAT int32 (float32 WAVs use a different chunk format that the
        # stdlib reader surfaces as 4-byte frames too; int32 scaling is the
        # safe interpretation here, matching the reference's i32 path).
        return np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    if sampwidth == 1:
        return (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    raise ValueError(f"unsupported WAV sample width: {sampwidth} bytes")


def load_reference_wav(path, expect_rate: int = 24000) -> np.ndarray:
    """Load a voice-cloning reference WAV: enforce sample rate, fold to mono.

    Mirrors the checks in engine.rs:337-373 (24 kHz assert, stereo -> ch0).
    """
    audio = AudioSample.load_wav(path)
    if audio.sample_rate != expect_rate:
        raise ValueError(
            f"Expected {expect_rate}Hz audio, found {audio.sample_rate}Hz: {path}")
    return audio.mono()
