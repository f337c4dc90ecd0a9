"""Streaming codec decode and encode from the published ONNX graphs.
Counterpart of qwen3_tts_tpu/models/codec/onnx_decoder.py.

A model directory laid out as the reference ships it holds the codec as
three ONNX graphs under `onnx/`: the streaming decoder
(qwen3_tts_decoder.onnx), the audio encoder (qwen3_tts_codec_encoder.onnx)
and the speaker encoder (qwen3_tts_speaker_encoder.onnx).  Each runs here
through io.onnx_exec on the engine's device, as the JAX classes run
jax.jit of the walk: `OnnxExecutor.jitted()`, one plan per shape signature
(feed shapes and dtypes; decode_batch's vmap also the batch size), its
first call an ordinary walk that records the plan, and on a CUDA device
one CUDA graph per signature from its second call, replayed after that
(io/onnx_exec's docstring: plan, graph, the bound of MAX_SIGNATURES
signatures an executor, the counters in `executor.stats`).  The decoder's
carried state is part of the signature: with a graph whose windows
saturate a stream's calls soon repeat their signatures; while the state
grows (the test fixture's KV) each call of one stream is a new signature,
and the next stream of the same chunk sizes replays.

Decoder state contract (the reference's): zero-length carried tensors
  pre_conv_history (1,512,0)  latent_buffer (1,1024,0)  conv_history (1,1024,0)
  past_key_i / past_value_i (1,16,0,64) for i in 0..8
inputs audio_codes [1,N,16] i64 + is_last [1] f32 and the state; outputs
final_wav, valid_samples and the next state, each `past_*` input carried
by the `next_*` output of the same suffix (`x` by `next_x`).  The state
stays on the device between calls; a call copies its waveform (and
valid_samples, where the graph computes it on the device) to the host.

A file that cannot be read, or whose graph lacks the contract's inputs and
outputs, raises OnnxLoadError naming the file; an op the executor does not
run raises UnsupportedOnnxOp naming the op, the node and the file; a CUDA
graph that cannot be captured raises OnnxCaptureError naming the file and
the signature, and no call falls back to the eager walk.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ...core import protocol as P
from ...io.onnx_exec import OnnxExecutor
from ...io.onnx_lite import read_onnx_graph


class OnnxLoadError(ValueError):
    """An .onnx file that cannot be read or does not have the expected
    inputs and outputs; the message names the file."""


def load_executor(path, device, inputs: Sequence[str],
                  outputs: Sequence[str]) -> OnnxExecutor:
    """The executor of one codec graph, checked against its contract: the
    graph must declare `inputs` and `outputs` (an empty `outputs`: any one
    output)."""
    try:
        graph = read_onnx_graph(path)
    except (OSError, ValueError, IndexError, KeyError, TypeError,
            struct.error) as e:
        raise OnnxLoadError(f"cannot read the ONNX graph {path}: {e!r}") from e
    have_in = {vi.name for vi in graph.inputs}
    have_out = {vi.name for vi in graph.outputs}
    missing = ([f"input {n!r}" for n in inputs if n not in have_in]
               + [f"output {n!r}" for n in outputs if n not in have_out])
    if not graph.nodes or not have_out or missing:
        raise OnnxLoadError(
            f"{path} is not the expected codec graph: {len(graph.nodes)} "
            f"nodes, inputs {sorted(have_in)}, outputs {sorted(have_out)}"
            + (f"; missing {', '.join(missing)}" if missing else ""))
    return OnnxExecutor(graph, device, source=str(path))


def _next_name(name: str) -> str:
    nxt = name.replace("past_", "next_")
    return nxt if nxt.startswith("next_") else "next_" + nxt


def _as_tensor(v, device) -> torch.Tensor:
    return (v if isinstance(v, torch.Tensor)
            else torch.as_tensor(np.array(v), device=device))


def _shapes(state: Dict[str, Any]) -> Dict[str, Tuple[int, ...]]:
    return {k: tuple(v.shape) for k, v in state.items()}


class OnnxStreamingDecoder:
    """codes -> waveform with functional carried state (the reference's
    AudioDecoder::decode)."""

    INPUTS = ("audio_codes", "is_last")
    OUTPUTS = ("final_wav",)

    def __init__(self, executor: OnnxExecutor):
        self.ex = executor
        self.device = executor.device
        names = set(executor.input_names)
        self.state_names: List[str] = sorted(
            n for n in names if n not in self.INPUTS)
        # zero-length start shapes from the graph's declared inputs: the
        # concrete dims as declared, the symbolic (streamed) ones 0
        self._init_shapes: Dict[str, Tuple[int, ...]] = {
            vi.name: tuple(d if isinstance(d, int) else 0 for d in vi.shape)
            for vi in executor.graph.inputs if vi.name in self.state_names}
        self._is_last = {f: torch.full((1,), float(f), device=self.device)
                         for f in (False, True)}
        self._run = executor.jitted()

    @classmethod
    def load(cls, path, device="cuda") -> "OnnxStreamingDecoder":
        return cls(load_executor(path, device, cls.INPUTS, cls.OUTPUTS))

    def create_state(self) -> Dict[str, torch.Tensor]:
        return {name: torch.zeros(self._init_shapes.get(name, (0,)),
                                  dtype=torch.float32, device=self.device)
                for name in self.state_names}

    def _frames(self, codes) -> torch.Tensor:
        """Codes (numpy or a tensor, [N, 16] or flat) -> [N', 16] int64 on
        the device: a trailing partial frame dropped, each code clamped to
        the codebook (the reference engine's rules)."""
        flat = (codes.reshape(-1) if isinstance(codes, torch.Tensor)
                else torch.from_numpy(np.asarray(codes, np.int64).reshape(-1)))
        n = flat.numel() // P.NUM_CODEBOOKS
        frames = flat[: n * P.NUM_CODEBOOKS].reshape(n, P.NUM_CODEBOOKS)
        return frames.to(self.device, torch.int64).clamp(
            0, P.CODEBOOK_SIZE - 1)

    def _next_state(self, out, state, pick=lambda v: v):
        return {name: (_as_tensor(pick(out[_next_name(name)]), self.device)
                       if _next_name(name) in out else state[name])
                for name in self.state_names}

    @torch.no_grad()
    def decode(self, codes, state: Dict[str, torch.Tensor],
               is_final: bool = False
               ) -> Tuple[np.ndarray, Dict[str, torch.Tensor]]:
        """One streaming step.  `codes`: [N, 16] or a flat multiple of 16
        (numpy or a tensor).  Returns (waveform f32 [valid_samples] on the
        host, new state on the device)."""
        frames = self._frames(codes)
        if frames.shape[0] == 0:
            return np.zeros(0, np.float32), state
        feeds = {"audio_codes": frames[None],
                 "is_last": self._is_last[bool(is_final)]}
        feeds.update(state)
        out = self._run(feeds)
        wav = _as_tensor(out["final_wav"], self.device).reshape(-1)
        if "valid_samples" in out:
            valid = out["valid_samples"]
            valid = int((valid.cpu() if isinstance(valid, torch.Tensor)
                         else np.asarray(valid)).reshape(-1)[0])
            wav = wav[:valid]
        return (wav.float().cpu().numpy(), self._next_state(out, state))

    @torch.no_grad()
    def decode_batch(self, codes, states: List[Dict[str, torch.Tensor]],
                     is_final=False):
        """A streaming step of B lanes in one call of the graph: the jitted
        walk's vmap over the batch-1 graph (`executor.jitted().vmap`, keyed
        by B with each lane's signature), so that each lane runs with its
        unbatched shapes (host shape folding untouched) and the values the
        graph computes on the host stay unbatched, as under JAX's vmap.
        codes: [B, n, 16]; states: B state dicts; is_final: a bool or B
        bools (a per-lane flush).  Lanes whose states differ in shape go
        one by one through `decode` (the reference's batch-1 contract).
        Returns (B f32 waveforms on the host, B new states).  Replayed,
        one call of 8 lanes beats 8 replayed `decode` calls 3.0-4.1x at
        the published decoder's widths (4 frames mid-stream, 32 fresh) on
        an H100 80GB HBM3 at 700 W (chip_smoke.py's onnx phase): each
        single call pays its graph launch, its copies in and out and its
        waveform's copy to the host."""
        b = len(states)
        finals = np.broadcast_to(np.asarray(is_final, bool), (b,))
        shapes0 = _shapes(states[0])
        if any(_shapes(s) != shapes0 for s in states[1:]):
            out = [self.decode(codes[i], states[i], bool(finals[i]))
                   for i in range(b)]
            return [w for w, _ in out], [s for _, s in out]
        frames = torch.stack([self._frames(codes[i]) for i in range(b)])
        if frames.shape[1] == 0:
            return [np.zeros(0, np.float32)] * b, states
        feeds = {"audio_codes": frames[:, None],
                 "is_last": torch.stack([self._is_last[bool(f)]
                                         for f in finals])}
        feeds.update({k: torch.stack([s[k] for s in states])
                      for k in self.state_names})
        out = self._run.vmap(feeds)
        wav = _as_tensor(out["final_wav"], self.device).reshape(b, -1)
        wav = wav.float().cpu().numpy()
        if "valid_samples" in out:
            v = out["valid_samples"]
            flat = (v.cpu().numpy() if isinstance(v, torch.Tensor)
                    else np.asarray(v)).reshape(-1)
            valid = flat if flat.size == b else np.full(b, int(flat[0]))
        else:
            valid = np.full(b, wav.shape[1])
        wavs = [wav[i, : int(valid[i])] for i in range(b)]
        new_states = [self._next_state(
            out, states[i],
            lambda v, i=i: v[i] if isinstance(v, torch.Tensor) else v)
            for i in range(b)]
        return wavs, new_states


def decode_lanes(decoder: OnnxStreamingDecoder, codes: Sequence,
                 ks: Sequence[int], states: List[Dict[str, torch.Tensor]],
                 finals: Sequence[bool]) -> List[np.ndarray]:
    """Waveforms of several lanes' chunks: lane i's first ks[i] frames of
    codes[i] ([n, 16]), flushed where finals[i]; no audio where ks[i] <= 0.
    Lanes in lockstep (the same k and state shapes) decode together through
    decode_batch, a lane out of step alone through decode.  states[i] is
    replaced by lane i's next state."""
    out = [np.zeros(0, np.float32)] * len(ks)
    groups: Dict[Any, List[int]] = {}
    for i, k in enumerate(ks):
        if int(k) > 0:
            key = (int(k), tuple(sorted(_shapes(states[i]).items())))
            groups.setdefault(key, []).append(i)
    for (k, _), lanes in groups.items():
        if len(lanes) == 1:
            i = lanes[0]
            out[i], states[i] = decoder.decode(codes[i][:k], states[i],
                                               bool(finals[i]))
            continue
        lane_codes = (torch.stack([codes[i][:k] for i in lanes])
                      if isinstance(codes[lanes[0]], torch.Tensor) else
                      np.stack([np.asarray(codes[i][:k]) for i in lanes]))
        wavs, new = decoder.decode_batch(
            lane_codes, [states[i] for i in lanes],
            is_final=np.asarray([bool(finals[i]) for i in lanes]))
        for j, i in enumerate(lanes):
            out[i], states[i] = wavs[j], new[j]
    return out


class OnnxAudioEncoder:
    """24 kHz waveform -> [N, 16] codec codes (the reference's
    AudioEncoder)."""

    INPUTS = ("input_values",)
    OUTPUTS = ("audio_codes",)

    def __init__(self, executor: OnnxExecutor):
        self.ex = executor
        self._run = executor.jitted()

    @classmethod
    def load(cls, path, device="cuda") -> "OnnxAudioEncoder":
        return cls(load_executor(path, device, cls.INPUTS, cls.OUTPUTS))

    @torch.no_grad()
    def encode(self, wav) -> np.ndarray:
        """wav f32 [T] (numpy or a tensor) -> codes int64 [N, 16]."""
        wav = (wav.float() if isinstance(wav, torch.Tensor)
               else torch.from_numpy(np.asarray(wav, np.float32)))
        out = self._run({"input_values": wav.reshape(1, -1)})
        codes = _as_tensor(out["audio_codes"], self.ex.device)
        codes = codes.cpu().numpy().astype(np.int64)
        return codes.reshape(codes.shape[-2], codes.shape[-1])


class OnnxSpeakerEncoder:
    """log-mel frames [F, 128] -> speaker embedding [2048] (the reference's
    speaker encoder net).  The log-mel front end is ops.mel."""

    INPUTS = ("mels",)
    OUTPUTS: Tuple[str, ...] = ()

    def __init__(self, executor: OnnxExecutor):
        self.ex = executor
        self._run = executor.jitted()

    @classmethod
    def load(cls, path, device="cuda") -> "OnnxSpeakerEncoder":
        return cls(load_executor(path, device, cls.INPUTS, cls.OUTPUTS))

    @torch.no_grad()
    def encode_mels(self, mels) -> np.ndarray:
        """mels f32 [F, 128] or [1, F, 128] (numpy or a tensor) -> the
        graph's `spk_emb` output (else its first) as f32 [2048]."""
        mels = (mels.float() if isinstance(mels, torch.Tensor)
                else torch.from_numpy(np.asarray(mels, np.float32)))
        if mels.dim() == 2:
            mels = mels[None]
        out = self._run({"mels": mels})
        emb = out["spk_emb"] if "spk_emb" in out else next(iter(out.values()))
        emb = _as_tensor(emb, self.ex.device)
        return emb.float().cpu().numpy().reshape(-1)
