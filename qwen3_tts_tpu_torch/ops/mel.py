"""Log-mel spectrogram front-end of the speaker encoder.  Counterpart of
qwen3_tts_tpu/ops/mel.py: 24 kHz input, n_fft 1024, hop 256, 128
Slaney-normalized mel bands, fmin 0 / fmax 12 kHz, reflect padding of
(n_fft - hop) / 2 on each side (not torch.stft's n_fft / 2), periodic Hann
window, magnitude sqrt(|X|^2 + 1e-9), then log(max(mel, 1e-5)).

The filterbank and the window are built on the host in numpy (copies of
the JAX package's functions: the port cannot import it); framing, FFT
(torch.fft.rfft) and the projection run on the audio's device.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def _hz_to_mel(freq: np.ndarray) -> np.ndarray:
    """Slaney mel scale."""
    freq = np.asarray(freq, np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    safe = np.maximum(freq, 1e-10)
    return np.where(freq >= min_log_hz,
                    min_log_mel + np.log(safe / min_log_hz) / logstep,
                    freq / f_sp)


def _mel_to_hz(mel: np.ndarray) -> np.ndarray:
    mel = np.asarray(mel, np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mel >= min_log_mel,
                    min_log_hz * np.exp(logstep * (mel - min_log_mel)),
                    f_sp * mel)


@lru_cache(maxsize=4)
def mel_filterbank(sample_rate: int = 24000, n_fft: int = 1024,
                   n_mels: int = 128, fmin: float = 0.0,
                   fmax: float = 12000.0) -> np.ndarray:
    """Slaney-normalized triangular filterbank [n_mels, n_fft//2 + 1] (f32)."""
    n_bins = n_fft // 2 + 1
    mel_edges = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                       n_mels + 2))
    fft_freqs = np.arange(n_bins) * sample_rate / n_fft
    fb = np.zeros((n_mels, n_bins), np.float64)
    for m in range(n_mels):
        f_left, f_center, f_right = mel_edges[m], mel_edges[m + 1], mel_edges[m + 2]
        norm = 2.0 / (f_right - f_left)
        up = (fft_freqs - f_left) / (f_center - f_left)
        down = (f_right - fft_freqs) / (f_right - f_center)
        weight = np.where(
            (fft_freqs >= f_left) & (fft_freqs <= f_center), up,
            np.where((fft_freqs > f_center) & (fft_freqs <= f_right), down, 0.0))
        fb[m] = weight * norm
    return fb.astype(np.float32)


def hann_window(n_fft: int) -> np.ndarray:
    """Periodic Hann (the reference's 1 - cos(2*pi*i/N) form)."""
    i = np.arange(n_fft, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * i / n_fft))).astype(np.float32)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """numpy's mode="reflect" pad of `pad` samples on both ends of the last
    axis, for any length: a signal shorter than the pad is reflected again
    and again (the padded signal is periodic with period 2 (T - 1)), where
    torch.nn.functional.pad(mode="reflect") raises.  T = 1 repeats the
    sample."""
    t = x.shape[-1]
    j = torch.arange(-pad, t + pad, device=x.device)
    if t > 1:
        period = 2 * (t - 1)
        j = j % period
        j = torch.where(j >= t, period - j, j)
    else:
        j = torch.zeros_like(j)
    return x[..., j]


def log_mel(audio: torch.Tensor, sample_rate: int = 24000, n_fft: int = 1024,
            hop_length: int = 256, n_mels: int = 128, fmin: float = 0.0,
            fmax: float = 12000.0) -> torch.Tensor:
    """audio f32 [T] (or [B, T]) -> log-mel [frames, n_mels] ([B, F, M]),
    frames = (T + 2 pad - n_fft) // hop + 1, or 0 when T + 2 pad < n_fft."""
    squeeze = audio.dim() == 1
    if squeeze:
        audio = audio[None]
    pad = (n_fft - hop_length) // 2
    x = reflect_pad(audio.float(), pad)
    dev = audio.device
    fb = torch.from_numpy(
        mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax)).to(dev)
    if x.shape[-1] < n_fft:
        out = torch.zeros((x.shape[0], 0, n_mels), dtype=torch.float32,
                          device=dev)
        return out[0] if squeeze else out
    frames = x.unfold(-1, n_fft, hop_length)               # [B, F, n_fft]
    frames = frames * torch.from_numpy(hann_window(n_fft)).to(dev)
    spec = torch.fft.rfft(frames, dim=-1)
    mag = torch.sqrt(spec.abs() ** 2 + 1e-9)               # [B, F, bins]
    mels = torch.matmul(mag, fb.t())
    out = torch.log(torch.clamp(mels, min=1e-5))
    return out[0] if squeeze else out
