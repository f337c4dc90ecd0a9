"""The engine's codec: one object over its two codec decoders, and one over
its two ways of encoding a reference, each chosen once when the engine is
built (TtsEngine.codec, TtsEngine.reference_encoder).  Every caller (the
engine's requests, streams, stream_batch, decode_codes and warmup; the
wave and continuous schedulers through serve/batch.py and
serve/codec_path.py) makes the same calls whichever codec runs.

NativeCodec: the port's codec decoder (models/codec/decoder) runs inside
the LM loop.  Each chunk of frames is decoded on the device as it is made
(Generator.chunk_with_audio, Generator.run_bulk), and a lane's samples are
cut from the chunk's waveform.

OnnxCodec: the published decoder graph (models/codec/onnx_decoder) runs
apart.  The LM loop makes codes only (Generator.chunk,
Generator.run_bulk_codes), and each lane's codes are decoded from that
lane's own decoder state when the caller reads them: lanes in lockstep
together through one decode_batch, a lane out of step alone
(onnx_decoder.decode_lanes), a lane flushed where its stream ends.

    cs = codec.new_state(batch)
    state, cs, codes, valid, wav = codec.chunk(state, cs, sampler,
                                               prompt_cap=cap, n_frames=n)
    state, cs, codes, valid, wav, saw_eos = codec.run_bulk(
        state, cs, sampler, prompt_cap=cap, max_frames=m, budgets=b)
    # ... wav, codes copied to the host ...
    pieces = codec.audio(wav_h, codes_h, ks, cs, finals)   # per lane
    cs = codec.reset_lanes(cs, mask)                        # on refill

`wav` is the chunk's waveform on the device, [B, n * wav_spf] (wav_spf
is 0 with the ONNX codec: it makes no audio on the device).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..core import protocol as P
from ..models.codec import decoder as codec_decoder
from ..models.codec import encoder as codec_encoder
from ..models.codec import speaker as speaker_lib
from ..models.codec.onnx_decoder import decode_lanes
from ..ops.mel import log_mel


class NativeCodec:
    """The native codec decoder, fused with the LM loop."""

    def __init__(self, generator, cfg, params, device):
        self.gen = generator
        self.cfg = cfg
        self.params = params
        self.device = device
        self.wav_spf = cfg.samples_per_frame

    def new_state(self, batch: int):
        return codec_decoder.init_decoder_state(self.cfg, batch, self.device)

    def reset_lanes(self, cs, mask: np.ndarray):
        """A fresh decoder state for the lanes in `mask` (bool [B])."""
        return codec_decoder.reset_lanes(
            cs, torch.as_tensor(mask, device=self.device))

    def chunk(self, state, cs, sampler, *, prompt_cap: int, n_frames: int,
              uniform_cursor: bool = True):
        return self.gen.chunk_with_audio(state, cs, sampler,
                                         prompt_cap=prompt_cap,
                                         n_frames=n_frames,
                                         uniform_cursor=uniform_cursor)

    def run_bulk(self, state, cs, sampler, *, prompt_cap: int,
                 max_frames: int, budgets=None, uniform_cursor: bool = True):
        state, cs, codes, valid, wav, _, saw_eos = self.gen.run_bulk(
            state, cs, sampler, prompt_cap=prompt_cap, max_frames=max_frames,
            budgets=budgets, uniform_cursor=uniform_cursor)
        return state, cs, codes, valid, wav, saw_eos

    def audio(self, wav_h: np.ndarray, codes_h, ks: Sequence[int], cs,
              finals: Sequence[bool]) -> List[np.ndarray]:
        """Lane i's first ks[i] frames of the chunk's waveform (none where
        ks[i] <= 0), copied off wav_h; the native codec needs no flush."""
        return [wav_h[i, : int(k) * self.wav_spf].copy() if int(k) > 0
                else np.zeros(0, np.float32) for i, k in enumerate(ks)]

    def decode_codes(self, codes: np.ndarray) -> np.ndarray:
        """Flat int32 codes (a multiple of 16) from a fresh state."""
        frames = torch.from_numpy(np.ascontiguousarray(
            codes.reshape(1, -1, P.NUM_CODEBOOKS))).to(self.device)
        wav, _ = codec_decoder.decode_chunk(self.cfg, self.params, frames,
                                            self.new_state(1))
        return wav[0].float().cpu().numpy()

    def warm_decoder(self, sizes: Sequence[int]) -> None:
        """Nothing: the LM loop's chunks decode their audio already."""


class OnnxCodec:
    """The published decoder graph, run on the codes apart from the LM
    loop; the state of B lanes is a list of B state dicts."""

    wav_spf = 0

    def __init__(self, generator, decoder):
        self.gen = generator
        self.decoder = decoder

    def new_state(self, batch: int):
        return [self.decoder.create_state() for _ in range(batch)]

    def reset_lanes(self, cs, mask: np.ndarray):
        for lane in np.nonzero(mask)[0]:
            cs[int(lane)] = self.decoder.create_state()
        return cs

    def chunk(self, state, cs, sampler, *, prompt_cap: int, n_frames: int,
              uniform_cursor: bool = True):
        state, codes, valid = self.gen.chunk(state, sampler,
                                             prompt_cap=prompt_cap,
                                             n_frames=n_frames,
                                             uniform_cursor=uniform_cursor)
        return (state, cs, codes, valid,
                valid.new_zeros((valid.shape[0], 0), dtype=torch.float32))

    def run_bulk(self, state, cs, sampler, *, prompt_cap: int,
                 max_frames: int, budgets=None, uniform_cursor: bool = True):
        state, codes, valid, _, saw_eos = self.gen.run_bulk_codes(
            state, sampler, prompt_cap=prompt_cap, max_frames=max_frames,
            budgets=budgets, uniform_cursor=uniform_cursor)
        return (state, cs, codes, valid,
                valid.new_zeros((valid.shape[0], 0), dtype=torch.float32),
                saw_eos)

    def audio(self, wav_h: np.ndarray, codes_h, ks: Sequence[int], cs,
              finals: Sequence[bool]) -> List[np.ndarray]:
        """Lane i's first ks[i] frames of codes_h[i] decoded from cs[i]
        (which advances), flushed where finals[i]; none where ks[i] <= 0."""
        return decode_lanes(self.decoder, codes_h, ks, cs, finals)

    def decode_codes(self, codes: np.ndarray) -> np.ndarray:
        wav, _ = self.decoder.decode(codes, self.decoder.create_state(),
                                     is_final=True)
        return wav

    def warm_decoder(self, sizes: Sequence[int]) -> None:
        """Zero codes through the decoder from a fresh state, a chunk of
        each of `sizes` in turn, so that a stream's first calls do not
        meet their shapes first."""
        cs = self.decoder.create_state()
        for n in sizes:
            _, cs = self.decoder.decode(
                np.zeros((n, P.NUM_CODEBOOKS), np.int64), cs)


def make_codec(generator, cfg, params, device, onnx_decoder):
    """The ONNX codec where the engine runs the decoder graph, else the
    native one on `params`."""
    if onnx_decoder is not None:
        return OnnxCodec(generator, onnx_decoder)
    return NativeCodec(generator, cfg, params, device)


class ReferenceEncoder:
    """24 kHz reference samples (a tensor [T] on the engine's device) ->
    (codec codes int32 [T // 2000, 16], speaker embedding f32 [2048])
    through the native encoders or their ONNX graphs (the speaker graph on
    ops.mel's log-mel), each chosen here."""

    def __init__(self, cfg, encoder_params, speaker_params, onnx_encoder,
                 onnx_speaker):
        if onnx_encoder is not None:
            self.codes = lambda x: onnx_encoder.encode(x).astype(np.int32)
        else:
            self.codes = lambda x: codec_encoder.encode(
                cfg.codec_encoder, encoder_params, x[None])[0].cpu().numpy()
        if onnx_speaker is not None:
            self.embedding = lambda x: onnx_speaker.encode_mels(log_mel(x))
        else:
            self.embedding = lambda x: speaker_lib.speaker_embed(
                cfg.speaker_encoder, speaker_params, x)[0].cpu().numpy()

    def __call__(self, x: torch.Tensor):
        return self.codes(x), self.embedding(x)
