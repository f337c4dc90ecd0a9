"""TtsEngine: the top-level facade.  Counterpart of qwen3_tts_tpu/engine.py:

    engine = TtsEngine("models", quant="q8_0", device="cuda")
    engine.set_max_steps(512); engine.set_sampler_config(SamplerConfig(...))
    audio = engine.generate_with_voice(text, engine.get_speaker("vivian"))
    voice = engine.create_voice_file("ref.wav", "ref text")
    audio = engine.generate(text, "ref.wav", "ref text")

A request is one prompt plan, assembled and prefilled on the device, then
the bulk loop (runtime/generate._gen_bulk) over 4-frame chunks, each
decoded to audio by the native codec, with an early exit at EOS; with the
ONNX codec (below) the loop makes codes only, and the published decoder
graph decodes them.  Which codec runs is decided once, at construction
(runtime/codec: self.codec, self.reference_encoder), and every method
goes through it.

Weights, in the JAX engine's order (qwen3_tts_tpu/engine.py), from
`model_dir` in the published layout: the assets
(`<weights dir>/qwen3_assets.gguf`, io/assets), the tokenizer, the talker
and predictor (`qwen3_tts_talker.gguf`, `qwen3_tts_predictor.gguf`,
io/weights: dims from the GGUF metadata), the codec decoder, codec
encoder and speaker encoder (`codec/decoder.npz`, `codec/encoder.npz`,
`codec/speaker.npz`, in their configs' dtypes; where an npz is missing,
the published ONNX graph `onnx/qwen3_tts_decoder.onnx`,
`onnx/qwen3_tts_codec_encoder.onnx` or `onnx/qwen3_tts_speaker_encoder.onnx`,
run by models/codec/onnx_decoder on the engine's device: an npz beside
an `.onnx` wins, as in the JAX engine).  The weights dir is
`gguf/` for quant="none", `gguf_q5_k_m/` / `gguf_q8_0/` for "q5_k_m" /
"q8_0" (QUANT_DIRS).  A component without its file runs on deterministic
random weights (development mode) at the configured widths, and the
engine says so loudly (QTTS_REQUIRE_WEIGHTS=1: it raises instead).  EngineConfig.int8_weights (None: quant != "none")
quantizes the talker's and predictor's layers and heads to int8 device
weights (ops.quant).  With weight_cache=True (the JAX package's
QTTS_WEIGHT_CACHE) the converted talker and predictor are saved under
`model_dir/cache/` (io/checkpoint) and read back by later engines.
`weights=` hands the components in directly (io/from_jax builds them from
the JAX package's arrays) and reads no weight file; a codec component it
does not hold runs its ONNX graph where model_dir has one, else random
weights.

Unlike the JAX engine, which logs a failed ONNX load and goes on with
native or random weights, an `.onnx` file that cannot be read, lacks its
graph's inputs and outputs or holds an op io/onnx_exec does not run
raises at construction, naming the file; a graph that fails to run raises
naming the file and the node.  Nothing goes quietly to random weights or
to the CPU.

Decode paths: `TtsEngine(fused=None, chunk=None)` (the defaults) resolve
once, at construction, as the JAX package resolves its own defaults.
fused=None is True on a CUDA device (or when chunk=True is asked for),
False on the CPU; chunk=None is True when fused is, talker_mode is "w4a8"
and the chunk kernel's gate holds at batch 1 and
cfg.runtime.frames_per_chunk.  So the card runs the chunk path and the
CPU the exact path by default:

- chunk (fused=True, chunk=True; the JAX package's default on its
  accelerator): each 4-frame chunk is ONE launch of the chunk kernel
  (kernels/chunk_step: sampler, projection, w4a8 predictor, feedback,
  w4a8 talker step and codec head for every frame).  chunk=None takes it
  at the batches where it measured faster than the per-kernel schedule
  (runtime/generate.CHUNK_BATCHES: one lane) and the per-kernel schedule
  at the others; chunk=True at every batch its gate takes;
- per-kernel (fused=True, chunk=False; QTTS_FUSED_CHUNK=0 in the JAX
  package): one talker-step kernel in `talker_mode` ("w4a8", "int8",
  "w8a8" or "bf16": the JAX package's QTTS_FUSED_TALKER) and one int8
  predictor-frame kernel per frame;
- exact (fused=False; QTTS_FUSED_*=0): the engine's weights (bf16 or
  int8) op by op.

The kernels pack their weights once, from bf16 or int8 weights.
fused=True or chunk=True on a config their kernels do not take,
chunk=True with fused=False, and chunk=True with a talker_mode other
than "w4a8" raise ValueError naming the failed gate; nothing falls back.
On the CPU the kernels' plain versions run.  The talker's prompt prefill
multiplies int8 weights a8w8 unless a8_prefill=False (the JAX package's
QTTS_A8_PREFILL).

Streaming (`generate_stream`, `stream_long`, `stream_batch`) yields audio
chunk by chunk: a first chunk of RuntimeConfig.first_chunk_frames frames
(0: a whole chunk), then chunks of frames_per_chunk, each one chunk of
the engine's codec (runtime/codec: Generator.chunk_with_audio, or
Generator.chunk with the ONNX codec).  One chunk runs ahead: chunk k + 1 is enqueued
before chunk k is read, and chunk k reaches the host by a non-blocking
copy into pinned memory (`_HostSlots`) started before chunk k + 1 is
enqueued, so reading it waits for chunk k alone.  A single stream stops at
the chunk where EOS occurs and drops the chunk ahead.

Prompt-prefix KV reuse (`_start_state`, the JAX engine's): a prompt whose
prefix (the instruction, control and speaker rows, and a clone voice's
reference) has PREFIX_CACHE_MIN_ROWS rows or more prefills only its suffix
after a copy of the prefix KV kept in an LRU of QTTS_PREFIX_CACHE_SIZE
entries (default 4; QTTS_PREFIX_CACHE=0 turns it off).  A miss prefills
the whole prompt once to fill the entry and then also goes through the
continued prefill, so that a voice's synthesis is the same from its first
request on.

Voice cloning from reference audio (`create_voice_file`, `generate`): the
24 kHz reference goes through the codec encoder (models/codec/encoder:
[frames, 16] RVQ codes) and the speaker encoder (ops/mel's log-mel, then
models/codec/speaker: a unit-norm 2048-d embedding) on the engine's
device; `generate` keeps both in a `.cache` sidecar beside the WAV
(io/cache, the reference implementation's format), read on later calls,
and prompts as a clone (PromptBuilder.plan_clone), whose reference rows
are its prefix and so go through the prefix-KV path above.  With the ONNX
encoders the codes come from the audio-encoder graph and the embedding
from the speaker-encoder graph on ops/mel's log-mel.

Threads (serve/online, serve/api): the kernels keep their scratch per
weights and batch size, not per caller (kernels/talker_step.kept_scratch:
the talker step's k/v token buffers, which the next launch,
append_kv_lanes, reads; the predictor frame's, the chunk kernel's and
flash_gqa_decode_append's workspaces), so two threads whose launches
interleave on one engine could overwrite each other's scratch between two
launches.  `device_lock`, one re-entrant lock an engine, is held by every
sequence of launches: a request (`_run_inference`), a stream's prefill
and each of its chunks (`_stream_inference`, `stream_batch`), `warmup`,
`set_max_steps` (it grows the config a worker reads) and each round of a
serving worker (serve/online).  Launches on one device go to its one
current stream in the order they were enqueued, so a sequence enqueued
whole under the lock runs whole on the card.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .core import protocol as P
from .core.config import EngineConfig, SamplerConfig
from .core.device import set_cuda_precision
from .io import cache as cache_io
from .io import checkpoint as ckpt_io
from .io import weights as weights_io
from .io.assets import Assets
from .io.audio import AudioSample, load_reference_wav
from .io.convert import load_params_npz
from .io.voice_file import VoiceFile
from .models import predictor as predictor_lib
from .models import talker as talker_lib
from .models.codec import decoder as codec_decoder
from .models.codec import encoder as codec_encoder
from .models.codec import speaker as speaker_lib
from .models.codec.onnx_decoder import (OnnxAudioEncoder, OnnxSpeakerEncoder,
                                        OnnxStreamingDecoder)
from .models.transformer import dtype_of
from .ops import quant as quant_ops
from .prompt import PromptBuilder, PromptPlan, assemble
from .runtime.codec import ReferenceEncoder, make_codec
from .runtime.generate import (CHUNK_BATCHES, Generator, SamplerParams,
                               chunk_unsupported, fused_unsupported)
from .utils.logging import get_logger, log_event
from .utils.metrics import GenerationMetrics, Stopwatch
from .utils.tokenizer import Tokenizer


class PromptTooLongError(ValueError):
    """Prompt exceeds the static prefill capacity."""


QUANT_DIRS = {"q5_k_m": "gguf_q5_k_m", "q8_0": "gguf_q8_0"}

# the codec's components: name -> (npz under model_dir/codec, the ONNX
# graph under model_dir/onnx run where the npz is missing, its runner,
# the engine attribute that holds the runner)
CODEC_PARTS = {
    "codec_decoder": ("decoder.npz", "qwen3_tts_decoder.onnx",
                      OnnxStreamingDecoder, "onnx_decoder"),
    "codec_encoder": ("encoder.npz", "qwen3_tts_codec_encoder.onnx",
                      OnnxAudioEncoder, "onnx_encoder"),
    "speaker_encoder": ("speaker.npz", "qwen3_tts_speaker_encoder.onnx",
                        OnnxSpeakerEncoder, "onnx_speaker"),
}

# EngineConfig fields the port does not read (see core/config.py), by
# sub-config ("" = EngineConfig itself)
IGNORED_FIELDS = {
    "talker": ("flash_decode", "layer_scan_unroll"),
    "predictor": ("flash_decode", "layer_scan_unroll"),
    "runtime": ("batch_size", "mesh_shape", "mesh_axes", "donate_cache"),
}


def check_config(config: EngineConfig) -> None:
    """Raise ValueError if `config` sets a field of IGNORED_FIELDS away
    from its default: the port has one path, and would ignore it."""
    base = EngineConfig()
    bad = [f"{sub}.{name}" if sub else name
           for sub, names in IGNORED_FIELDS.items() for name in names
           if getattr(getattr(config, sub) if sub else config, name)
           != getattr(getattr(base, sub) if sub else base, name)]
    if bad:
        raise ValueError(f"qwen3_tts_tpu_torch does not read {bad}: leave "
                         "them at their defaults")


class TtsEngine:
    """Owns the models, assets, tokenizer and speakers of one device."""

    def __init__(self, model_dir="models", config: Optional[EngineConfig] = None,
                 init_seed: int = 0, speakers_dir=None, device="cuda",
                 weights: Optional[Dict] = None,
                 fused: Optional[bool] = None,
                 chunk: Optional[bool] = None, quant: str = "none",
                 talker_mode: str = "w4a8", a8_prefill: bool = True,
                 weight_cache: bool = True):
        """model_dir, quant: where the weights are read (module docstring);
        weights: optional {"assets": Assets, "talker", "predictor",
        "codec_decoder" and optionally "codec_encoder", "speaker_encoder":
        param dicts} already on `device`, read instead of any file;
        init_seed: the seed of development weights.  fused,
        chunk, talker_mode: the decode path (module docstring); None,
        None = the chunk path on a CUDA device, the exact path on the CPU.
        a8_prefill: a8w8 prompt prefill on int8 weights.  weight_cache:
        save and read the converted talker and predictor under
        model_dir/cache/."""
        self.device = torch.device(device)
        self.device_lock = threading.RLock()    # module docstring: Threads
        if self.device.type == "cuda":
            set_cuda_precision()
        self.model_dir = Path(model_dir)
        self.quant = quant
        self.config = config or EngineConfig()
        check_config(self.config)
        self.max_steps = self.config.runtime.max_steps
        self.sampler_config = SamplerConfig(
            temperature=self.config.sampler.temperature,
            top_k=self.config.sampler.top_k,
            top_p=self.config.sampler.top_p,
            seed=self.config.sampler.seed)
        self.speakers: Dict[str, VoiceFile] = {}
        self.last_metrics: Optional[GenerationMetrics] = None
        self.last_codes: Optional[np.ndarray] = None
        self.dev_mode_components: list = []
        self.load_seconds: Dict[str, float] = {}   # build time by part
        self.weight_sources: Dict[str, str] = {}   # LM: "gguf" or "cache"
        # prompt-prefix KV, (fingerprint, p_cap) -> (k, v): contiguous
        # copies of p_cap slots, least recently used first
        self._prefix_kv: collections.OrderedDict = collections.OrderedDict()
        self._prefix_kv_max = int(os.environ.get("QTTS_PREFIX_CACHE_SIZE",
                                                 "4"))

        use_int8 = self.config.int8_weights
        if use_int8 is None:
            use_int8 = quant != "none"
        if weights is None:
            weights = self._load_weights(init_seed, use_int8, weight_cache)
        elif use_int8:
            weights = dict(weights,
                           talker=self._int8_lm(weights["talker"],
                                                "codec_head"),
                           predictor=self._int8_lm(weights["predictor"],
                                                   "lm_head"))
        weights = dict(weights)
        # the ONNX graph of each codec component without weights, else
        # random weights; None in `weights` where the graph runs
        self.onnx_decoder: Optional[OnnxStreamingDecoder] = None
        self.onnx_encoder: Optional[OnnxAudioEncoder] = None
        self.onnx_speaker: Optional[OnnxSpeakerEncoder] = None
        for name, (_, onnx_file, runner, attr) in CODEC_PARTS.items():
            if name in weights:
                continue
            path = self.model_dir / "onnx" / onnx_file
            if path.exists():
                t0 = time.perf_counter()
                setattr(self, attr, runner.load(path, self.device))
                self.load_seconds[attr] = time.perf_counter() - t0
                weights[name] = None
            else:
                weights[name] = self._random_component(name, init_seed)
        self._warn_dev_mode()
        self.assets: Assets = weights["assets"]
        self.talker_params = weights["talker"]
        self.predictor_params = weights["predictor"]
        self.codec_decoder_params = weights["codec_decoder"]
        # None where the component's ONNX graph runs
        self.codec_encoder_params = weights["codec_encoder"]
        self.speaker_params = weights["speaker_encoder"]
        self.tokenizer = Tokenizer.load(self.model_dir)

        self.talker_mode = talker_mode
        self.fused = (self.device.type == "cuda" or chunk is True) \
            if fused is None else bool(fused)
        if chunk and not self.fused:
            raise ValueError("chunk decode path: needs fused=True")
        if chunk and talker_mode != "w4a8":
            raise ValueError("chunk decode path: runs the w4a8 talker step, "
                             f"not talker_mode={talker_mode!r}")
        why = (fused_unsupported(self.config, 1, talker_mode)
               if self.fused else None)
        if why:
            raise ValueError(f"fused decode path: {why}")
        why = chunk_unsupported(self.config) if self.fused else "fused off"
        if chunk and why:
            raise ValueError(f"chunk decode path: {why}")
        self.chunk = (why is None and talker_mode == "w4a8"
                      if chunk is None else bool(chunk))
        log_event("decode_path", fused=self.fused, chunk=self.chunk,
                  talker_mode=talker_mode, a8_prefill=a8_prefill,
                  int8_weights=bool(use_int8), requested_fused=fused,
                  requested_chunk=chunk, device=str(self.device))
        t0 = time.perf_counter()
        self.generator = Generator(self.config, self.talker_params,
                                   self.predictor_params, self.assets.pack(),
                                   codec_params=self.codec_decoder_params,
                                   fused=self.fused, chunk=self.chunk,
                                   talker_mode=talker_mode,
                                   a8_prefill=a8_prefill,
                                   chunk_batches=(CHUNK_BATCHES if chunk is None
                                                  else None))
        self.load_seconds["kernel_pack"] = time.perf_counter() - t0
        # which codec runs is decided here, once (runtime/codec)
        self.codec = make_codec(self.generator, self.config.codec_decoder,
                                self.codec_decoder_params, self.device,
                                self.onnx_decoder)
        self.reference_encoder = ReferenceEncoder(
            self.config, self.codec_encoder_params, self.speaker_params,
            self.onnx_encoder, self.onnx_speaker)

        for cand in ([Path(speakers_dir)] if speakers_dir else
                     [self.model_dir / "preset_speakers", Path("speakers")]):
            if cand.exists():
                self.load_speakers(cand)
                break

    def _load_weights(self, seed: int, use_int8: bool,
                      weight_cache: bool) -> Dict:
        """Every component from its file under model_dir, or random
        (module docstring), in the JAX engine's order; a codec component
        without its npz is left out (its ONNX graph, else random weights,
        in __init__).  self.config takes the GGUF metadata's dims."""
        from .core.config import PredictorConfig, TalkerConfig
        cfg, dev = self.config, self.device
        weights_dir = self.model_dir / QUANT_DIRS.get(self.quant, "gguf")
        t0 = time.perf_counter()
        try:
            assets = Assets.load(weights_dir, dtype=dtype_of(cfg.talker.dtype),
                                 device=dev)
        except FileNotFoundError:
            assets = self._random_component("assets", seed)
        self.load_seconds["assets"] = time.perf_counter() - t0

        out = {"assets": assets}
        for name, fname, cfg_cls, loader, head in (
                ("talker", "qwen3_tts_talker.gguf", TalkerConfig,
                 weights_io.load_talker_gguf, "codec_head"),
                ("predictor", "qwen3_tts_predictor.gguf", PredictorConfig,
                 weights_io.load_predictor_gguf, "lm_head")):
            t0 = time.perf_counter()
            path = weights_dir / fname
            cache_name = f"{name}_{self.quant}"
            fp = ckpt_io.fingerprint(path, use_int8) if path.exists() else None
            hit = (ckpt_io.load_lm(self.model_dir, cache_name, fp, cfg_cls,
                                   dev) if fp and weight_cache else None)
            if hit is not None:
                params, sub_cfg = hit
                self.weight_sources[name] = "cache"
            else:
                if fp is None:
                    params = self._random_component(name, seed)
                    sub_cfg = getattr(self.config, name)
                else:
                    with torch.no_grad():
                        sub_cfg, params = loader(
                            path, getattr(self.config, name), dev)
                    self.weight_sources[name] = "gguf"
                if use_int8:
                    params = self._int8_lm(params, head)
                if fp is not None and weight_cache:
                    ckpt_io.save_lm(self.model_dir, cache_name, params,
                                    sub_cfg, fp)
            self.config = self.config.replace(**{name: sub_cfg})
            out[name] = params
            self.load_seconds[name] = time.perf_counter() - t0

        for name, (npz, _, _, _) in CODEC_PARTS.items():
            path = self.model_dir / "codec" / npz
            if path.exists():
                out[name] = load_params_npz(path, dev,
                                     dtype_of(getattr(cfg, name).dtype))
        return out

    @staticmethod
    def _int8_lm(params: Dict, head: str) -> Dict:
        """int8 device weights of an LM (the JAX engine's step 4.5): the
        layers' matrices and the head; norms stay.  Already int8: as is."""
        if quant_ops.is_quantized(params[head]):
            return params
        with torch.no_grad():
            return dict(params,
                        layers=quant_ops.quantize_decoder_layers(
                            params["layers"]),
                        **{head: quant_ops.quantize_head(params[head])})

    def _random_component(self, name: str, seed: int):
        """Deterministic random weights of one component (development
        mode): the JAX init's shapes, scales and dtypes, other draws."""
        self.dev_mode_components.append(name)
        cfg = self.config
        i = ("assets", "talker", "predictor", "codec_decoder",
             "codec_encoder", "speaker_encoder").index(name)
        g = torch.Generator(device=self.device).manual_seed(seed + i)
        with torch.no_grad():
            if name == "assets":
                return Assets.random_init(g, dtype=dtype_of(cfg.talker.dtype))
            if name == "talker":
                return talker_lib.init_talker_params(cfg.talker, g)
            if name == "predictor":
                return predictor_lib.init_predictor_params(cfg.predictor, g)
            if name == "codec_encoder":
                return codec_encoder.init_encoder_params(cfg.codec_encoder, g)
            if name == "speaker_encoder":
                return speaker_lib.init_speaker_params(cfg.speaker_encoder, g)
            return codec_decoder.init_decoder_params(cfg.codec_decoder, g)

    def _warn_dev_mode(self) -> None:
        """Loudly flag components on random weights: synthesis is noise.
        QTTS_REQUIRE_WEIGHTS=1 turns the warning into a RuntimeError."""
        if not self.dev_mode_components:
            return
        msg = (f"DEV MODE: no trained weights found for "
               f"[{', '.join(self.dev_mode_components)}] under "
               f"{self.model_dir} (quant={self.quant!r}) — synthesis will "
               "be NOISE, not speech.  Place the model files "
               "(gguf*/*.gguf, codec/*.npz or onnx/*.onnx) in the model "
               "dir.")
        if os.environ.get("QTTS_REQUIRE_WEIGHTS") == "1":
            raise RuntimeError(msg)
        get_logger().warning(msg)

    # ------------------------------------------------------------------ API
    def set_max_steps(self, steps: int) -> None:
        """Set the frame budget.  Above the runtime config's max_steps the
        config grows with it (the KV capacity derives from it)."""
        import dataclasses
        steps = int(steps)
        with self.device_lock:
            self.max_steps = steps
            if steps > self.config.runtime.max_steps:
                self.config = self.config.replace(
                    runtime=dataclasses.replace(self.config.runtime,
                                                max_steps=steps))
                self.generator.cfg = self.config

    def set_sampler_config(self, config: SamplerConfig) -> None:
        self.sampler_config = config

    def load_speakers(self, speakers_dir) -> None:
        for path in sorted(Path(speakers_dir).glob("*.json")):
            if path.name == "index.json":
                continue
            try:
                self.speakers[path.stem] = VoiceFile.load(path)
            except (OSError, ValueError, TypeError) as e:
                get_logger().warning("skipping speaker file %s: %r", path, e)

    def get_speaker(self, id_or_name: str) -> VoiceFile:
        """ID -> name -> 'vivian' -> any."""
        if id_or_name in self.speakers:
            return self.speakers[id_or_name]
        for v in self.speakers.values():
            if v.name == id_or_name:
                return v
        if P.DEFAULT_SPEAKER in self.speakers:
            return self.speakers[P.DEFAULT_SPEAKER]
        if not self.speakers:
            raise RuntimeError("No speakers loaded in engine!")
        return next(iter(self.speakers.values()))

    # ----------------------------------------------------------- synthesis
    def generate_with_voice(self, text: str, voice: VoiceFile,
                            instruct: Optional[str] = None) -> AudioSample:
        plan = self._build_voice_prompt(text, voice, instruct)
        return self._run_inference(plan)

    def generate(self, text: str, ref_audio_path, ref_text: str,
                 instruct: Optional[str] = None) -> AudioSample:
        """Clone the voice of a 24 kHz reference WAV (its codes and speaker
        embedding from the `.cache` sidecar where one loads,
        _process_reference) and synthesize `text` in it."""
        codes, emb = self._process_reference(ref_audio_path)
        plan = PromptBuilder.plan_clone(
            text, self.tokenizer, ref_codes=codes,
            ref_text_ids=self.tokenizer.encode(ref_text),
            spk_emb=self._safe_emb(emb), lang_id=self.config.lang_id,
            instruct=instruct)
        return self._run_inference(plan)

    def create_voice_file(self, audio_path, ref_text: str) -> VoiceFile:
        """A clone VoiceFile of a 24 kHz reference WAV: its codec codes
        (flattened [frames, 16]) and speaker embedding, computed on the
        engine's device."""
        codes, emb = self.encode_reference(load_reference_wav(audio_path))
        return VoiceFile.new(ref_text, codes.reshape(-1), emb)

    @torch.no_grad()
    def encode_reference(self, wav: np.ndarray) -> Tuple[np.ndarray,
                                                         np.ndarray]:
        """Reference samples f32 [T] at 24 kHz -> (codes int32 [T // 2000,
        16], speaker embedding f32 [2048]), through the native encoders or
        their ONNX graphs (the speaker graph on ops/mel's log-mel)."""
        return self.reference_encoder(torch.from_numpy(
            np.ascontiguousarray(wav, np.float32)).to(self.device))

    def _process_reference(self, audio_path) -> Tuple[np.ndarray, np.ndarray]:
        """Codes + speaker embedding of a reference WAV through its
        `.cache` sidecar: read where it loads; else computed and written
        (a sidecar that cannot be written is skipped)."""
        audio_path = Path(audio_path)
        cache_path = audio_path.with_suffix(".cache")
        if cache_path.exists():
            try:
                return cache_io.load_cache(cache_path)
            except (OSError, ValueError) as e:
                get_logger().warning("recomputing the unreadable reference "
                                     "cache %s: %r", cache_path, e)
        codes, emb = self.encode_reference(load_reference_wav(audio_path))
        codes = codes.astype(np.int64).reshape(-1)
        try:
            cache_io.save_cache(cache_path, codes, emb)
        except OSError as e:
            get_logger().warning("reference cache %s not written: %r",
                                 cache_path, e)
        return codes, emb

    @torch.no_grad()
    def decode_codes(self, codes) -> AudioSample:
        """Raw codec codes ([frames, 16] or flattened; a trailing partial
        frame dropped) to audio through the codec decoder, e.g. to listen
        to a VoiceFile's reference codes."""
        codes = np.asarray(codes, np.int32).reshape(-1)
        n = len(codes) // P.NUM_CODEBOOKS
        return AudioSample(
            samples=self.codec.decode_codes(codes[: n * P.NUM_CODEBOOKS]),
            sample_rate=P.SAMPLE_RATE, channels=1)

    @torch.no_grad()
    def warmup(self, buckets=(32, 64, 128), batch_sizes=(1,),
               frames: Optional[int] = None) -> None:
        """Build the kernels and make the device's plans before the first
        request, so that none pays for them: for each batch size and
        prompt bucket one prefill and one chunk of `frames` (default
        frames_per_chunk) with its audio, from zero prompts (the chunk
        kernel's scratch for that batch and cache capacity; with the ONNX
        decoder the chunk makes codes only, and the decoder graph then
        decodes zero codes from a fresh state, a stream's first chunk
        (first_chunk_frames) and two of `frames`, so that a stream's first
        decoder calls do not meet their shapes first), then one second of
        silence through the mel, codec encoder and speaker encoder (the
        cuFFT and cuDNN plans).  No request's state, sampler or prefix
        entry changes."""
        with self.device_lock:
            frames = frames or self.config.runtime.frames_per_chunk
            sampler = SamplerParams.make(self.sampler_config)
            dev = self.device
            for b in batch_sizes:
                for bucket in buckets:
                    state = self.generator.start(
                        torch.zeros((b, bucket, P.TALKER_DIM), device=dev),
                        torch.full((b,), bucket, dtype=torch.int32,
                                   device=dev),
                        torch.Generator(device=dev).manual_seed(0))
                    self.codec.chunk(state, self.codec.new_state(b), sampler,
                                     prompt_cap=bucket, n_frames=frames)
            first = self.config.runtime.first_chunk_frames or frames
            self.codec.warm_decoder((first, frames, frames))
            self.encode_reference(np.zeros(P.SAMPLE_RATE, np.float32))
            self._sync()

    def generate_stream(self, text: str, voice: VoiceFile,
                        instruct: Optional[str] = None
                        ) -> Iterator[np.ndarray]:
        """Yield float32 waveform chunks while the talker is still
        generating: first_chunk_frames frames first, then frames_per_chunk
        (module docstring)."""
        plan = self._build_voice_prompt(text, voice, instruct)
        yield from self._stream_inference(plan)

    def stream_long(self, text: str, voice: VoiceFile,
                    instruct: Optional[str] = None,
                    max_chars: int = 120) -> Iterator[np.ndarray]:
        """generate_stream over the sentences of `text` (split_sentences),
        one after the other."""
        for piece in split_sentences(text, max_chars):
            yield from self.generate_stream(piece, voice, instruct)

    def generate_long(self, text: str, voice: VoiceFile,
                      instruct: Optional[str] = None,
                      max_chars: int = 120) -> AudioSample:
        """Long text: each piece of split_sentences(text, max_chars)
        synthesized with the same voice and instruction, the audio
        concatenated."""
        parts = []
        for piece in split_sentences(text, max_chars):
            audio = self.generate_with_voice(piece, voice, instruct)
            if len(audio.samples):
                parts.append(audio.samples)
        samples = (np.concatenate(parts) if parts
                   else np.zeros(0, np.float32))
        return AudioSample(samples=samples, sample_rate=P.SAMPLE_RATE,
                           channels=1)

    @torch.no_grad()
    def stream_batch(self, texts, voices, instructs=None
                     ) -> Iterator[List[np.ndarray]]:
        """Batched streaming: a wave of len(texts) requests decodes at one
        prompt bucket, and every chunk boundary yields a list of one
        float32 waveform piece per request (zero-length once a request
        has finished).  The first chunk, first_chunk_frames long, follows
        the wave's assembly and prefill (Generator.start_from_plans); the
        stream ends when every lane has finished or at
        max_steps.  One chunk runs ahead, as in generate_stream.  Each
        chunk goes through self.codec (runtime/codec): with the ONNX codec
        a chunk makes codes only, and the pieces are decoded when the
        chunk is read, each lane flushed at its last chunk."""
        cfg = self.config
        b = len(texts)
        if isinstance(voices, VoiceFile):
            voices = [voices] * b
        if instructs is None or isinstance(instructs, str):
            instructs = [instructs] * b
        plans = [self._build_voice_prompt(t, v, i)
                 for t, v, i in zip(texts, voices, instructs)]
        a, lengths, bucket = self._plans_to_arrays(plans)
        gen = self._torch_generator()
        sampler = SamplerParams.make(self.sampler_config)
        n_chunk = cfg.runtime.frames_per_chunk
        first_n = cfg.runtime.first_chunk_frames
        first_n = min(first_n, n_chunk) if first_n > 0 else n_chunk
        dev = self.device
        codec = self.codec
        slots = _HostSlots(dev, b, max(first_n, n_chunk), codec.wav_spf)
        done = np.zeros(b, bool)
        t = {k: torch.from_numpy(v).to(dev) for k, v in a.items()}
        with self.device_lock:
            state = self.generator.start_from_plans(
                self.assets.text_table, self.assets.codec_tables,
                t["text_idx"], t["codec_idx"], t["frame_slot"],
                t["spk_flag"], t["frames"], t["spk_emb"],
                torch.from_numpy(lengths).to(dev), gen)
            state, cs, codes, valid, wav = codec.chunk(
                state, codec.new_state(b), sampler, prompt_cap=bucket,
                n_frames=first_n)
            pending = slots.put(wav, valid, codes, first_n)
        steps = first_n
        while pending is not None:
            nxt = None
            if steps < self.max_steps:
                n = min(n_chunk, self.max_steps - steps)
                with self.device_lock:
                    state, cs, codes, valid, wav = codec.chunk(
                        state, cs, sampler, prompt_cap=bucket, n_frames=n)
                    nxt = slots.put(wav, valid, codes, n)
                steps += n
            wav_h, valid_h, codes_h, n0 = _HostSlots.get(pending)
            n_valid = valid_h.sum(1)
            # zero-length pieces for the lanes already done
            with self.device_lock:
                pieces = codec.audio(wav_h, codes_h,
                                     np.where(done, 0, n_valid), cs,
                                     (n_valid < n0) | (nxt is None))
            yield pieces
            done |= n_valid < n0
            if done.all():
                break
            pending = nxt

    @staticmethod
    def _safe_emb(emb: np.ndarray) -> np.ndarray:
        """Coerce a speaker embedding to the protocol width (2048)."""
        emb = np.asarray(emb, np.float32).reshape(-1)
        if emb.shape[0] == P.SPEAKER_EMB_DIM:
            return emb
        get_logger().warning(
            "speaker embedding has %d dims, expected %d — padding/truncating",
            emb.shape[0], P.SPEAKER_EMB_DIM)
        out = np.zeros(P.SPEAKER_EMB_DIM, np.float32)
        out[: min(emb.shape[0], P.SPEAKER_EMB_DIM)] = emb[: P.SPEAKER_EMB_DIM]
        return out

    def _build_voice_prompt(self, text: str, voice: VoiceFile,
                            instruct: Optional[str]) -> PromptPlan:
        emb = self._safe_emb(voice.embedding_array)
        if not voice.audio_codes:
            return PromptBuilder.plan_core(
                text, self.tokenizer, lang_id=self.config.lang_id,
                spk_id=None, spk_emb=emb, instruct=instruct)
        return PromptBuilder.plan_clone(
            text, self.tokenizer,
            ref_codes=np.asarray(voice.audio_codes, np.int32),
            ref_text_ids=self.tokenizer.encode(voice.ref_text),
            spk_emb=emb, lang_id=self.config.lang_id, instruct=instruct)

    def _plans_to_arrays(self, plans, bucket: Optional[int] = None):
        """Stack padded plan arrays for a batch of PromptPlans.
        Returns (dict of stacked numpy arrays, lengths [B] int32, bucket)."""
        if isinstance(plans, PromptPlan):
            plans = [plans]
        max_len = max(p.length for p in plans)
        bucket = bucket or self._bucket(max_len)
        if max_len > bucket:
            raise PromptTooLongError(
                f"prompt is {max_len} rows but capacity is {bucket} "
                f"(max_prompt_len={self.config.runtime.max_prompt_len}). "
                "Shorten the text or raise RuntimeConfig.max_prompt_len.")
        f_need = max(p.frames.shape[0] for p in plans)
        f_cap = 1 if f_need <= 1 else ((f_need + 63) // 64) * 64
        padded = [p.padded(bucket, f_cap) for p in plans]
        lengths = np.asarray([p.length for p in plans], np.int32)
        arrays = dict(
            text_idx=np.stack([p.text_idx for p in padded]),
            codec_idx=np.stack([p.codec_idx for p in padded]),
            frame_slot=np.stack([p.frame_slot for p in padded]),
            spk_flag=np.stack([p.spk_flag for p in padded]),
            frames=np.stack([p.frames for p in padded]),
            spk_emb=np.stack([p.spk_emb for p in padded]))
        return arrays, lengths, bucket

    def _bucket(self, s: int) -> int:
        """Round the prompt length up to a power-of-two bucket (>= 32)."""
        cap = self.config.runtime.max_prompt_len
        b = 32
        while b < s and b < cap:
            b *= 2
        return min(max(b, 32), cap)

    def prompt_to_device(self, plans, bucket: Optional[int] = None):
        """Assemble PromptPlans to embeddings on the device.  Returns
        (embeds [B, bucket, 2048] f32, lengths [B] int32 numpy)."""
        a, lengths, bucket = self._plans_to_arrays(plans, bucket)
        t = {k: torch.from_numpy(v).to(self.device) for k, v in a.items()}
        embeds = assemble(
            self.assets.text_table, self.assets.codec_tables, t["text_idx"],
            t["codec_idx"], t["frame_slot"], t["spk_flag"], t["frames"],
            t["spk_emb"], torch.from_numpy(lengths).to(self.device))
        return embeds, lengths

    def start_plans(self, plans, bucket: Optional[int],
                    generator: torch.Generator):
        """Assembly + prefill of one plan or a list of plans (a wave) at
        one bucket (None: the longest plan's).  Returns (GenState,
        lengths [B] int32 numpy, bucket)."""
        a, lengths, bucket = self._plans_to_arrays(plans, bucket)
        dev = self.device
        t = {k: torch.from_numpy(v).to(dev) for k, v in a.items()}
        state = self.generator.start_from_plans(
            self.assets.text_table, self.assets.codec_tables, t["text_idx"],
            t["codec_idx"], t["frame_slot"], t["spk_flag"], t["frames"],
            t["spk_emb"], torch.from_numpy(lengths).to(dev), generator)
        return state, lengths, bucket

    # below this many prefix rows a prefix prefill is cheap
    PREFIX_CACHE_MIN_ROWS = 64

    def _start_state(self, plan, generator: torch.Generator):
        """Assembly + prefill of one plan, reusing the prompt-prefix KV of
        its voice and instruction (module docstring; the JAX engine's
        _start_state), or of a list of plans at one bucket.  Returns
        (GenState, bucket)."""
        use_prefix = (isinstance(plan, PromptPlan)
                      and os.environ.get("QTTS_PREFIX_CACHE", "1") != "0"
                      and plan.prefix_len >= self.PREFIX_CACHE_MIN_ROWS
                      and plan.length <= self.config.runtime.max_prompt_len)
        if use_prefix:
            p_cap = ((plan.prefix_len + 63) // 64) * 64
            suffix = plan.suffix_plan()
            s_cap = ((suffix.length + 15) // 16) * 16
            bucket = self._bucket(max(plan.length, p_cap,
                                      plan.prefix_len + s_cap))
            # _bucket stops at max_prompt_len: the suffix's pad rows must
            # not spill past the prompt region into decode slots
            use_prefix = plan.prefix_len + s_cap <= bucket and p_cap <= bucket
        if not use_prefix:
            state, _, bucket = self.start_plans(plan, None, generator)
            return state, bucket

        fp = (plan.prefix_fingerprint(), p_cap)
        entry = self._prefix_kv.get(fp)
        if entry is None:
            full, _, _ = self.start_plans(plan, bucket, generator)
            # slots [0, p_cap) of this prefill are the prefix KV; a copy,
            # so that the entry holds p_cap slots and not the whole cache
            entry = tuple(t[:, :, :, :p_cap].clone(
                memory_format=torch.contiguous_format)
                for t in (full.cache.k, full.cache.v))
            del full
            self._prefix_kv[fp] = entry
            while len(self._prefix_kv) > self._prefix_kv_max:
                self._prefix_kv.popitem(last=False)
        else:
            self._prefix_kv.move_to_end(fp)
        # a miss too goes on through the continued prefill: the full and
        # the continued prefill tile differently on the card
        a, lens_s, _ = self._plans_to_arrays(suffix, s_cap)
        dev = self.device
        t = {k: torch.from_numpy(v).to(dev) for k, v in a.items()}
        state = self.generator.start_with_prefix_from_plans(
            entry[0], entry[1], plan.prefix_len, self.assets.text_table,
            self.assets.codec_tables, t["text_idx"], t["codec_idx"],
            t["frame_slot"], t["spk_flag"], t["frames"], t["spk_emb"],
            torch.from_numpy(lens_s).to(dev), generator, total_bucket=bucket)
        return state, bucket

    def _torch_generator(self) -> torch.Generator:
        """The request's generator, seeded from the sampler config (a
        fresh seed when it has none)."""
        seed = self.sampler_config.seed
        if seed is None:
            seed = time.time_ns() & 0x7FFFFFFFFFFFFFFF
        return torch.Generator(device=self.device).manual_seed(seed)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def _run_inference(self, plan: PromptPlan) -> AudioSample:
        """Non-streaming synthesis: prefill, then the bulk chunk loop with
        the codec decode of each chunk; early exit at EOS.  With the ONNX
        codec the loop makes codes only, and the decoder graph decodes
        them in one call from a fresh state (the JAX engine's rule)."""
        with self.device_lock:
            cfg = self.config
            spf = cfg.codec_decoder.samples_per_frame
            codec = self.codec
            metrics = GenerationMetrics()
            watch = Stopwatch()
            t_start = time.perf_counter()
            state, bucket = self._start_state(plan, self._torch_generator())
            sampler = SamplerParams.make(self.sampler_config)
            self._sync()
            metrics.prefill_ms = watch.lap_ms()
            max_frames = min(self.max_steps, cfg.runtime.max_steps)
            state, cs, codes, valid, wav, saw_eos = codec.run_bulk(
                state, codec.new_state(1), sampler, prompt_cap=bucket,
                max_frames=max_frames)
            n_valid = int(valid[0].sum())
            codes_h = codes.cpu().numpy()
            samples = codec.audio(wav.cpu().numpy(), codes_h, [n_valid], cs,
                                  [True])[0]
            metrics.eos = bool(saw_eos[0])
            self.last_codes = codes_h[0, :n_valid]

            metrics.total_ms = (time.perf_counter() - t_start) * 1000.0
            metrics.ttft_ms = None       # a streaming metric
            metrics.frames = n_valid
            metrics.audio_seconds = n_valid * spf / P.SAMPLE_RATE
            self.last_metrics = metrics
            log_event("generation", **metrics.as_dict())
            return AudioSample(samples=samples, sample_rate=P.SAMPLE_RATE,
                               channels=1)

    @torch.no_grad()
    def _stream_inference(self, plan: PromptPlan) -> Iterator[np.ndarray]:
        """Streaming synthesis of one plan (module docstring): prefill,
        then chunks of gen_frames + codec decode, one chunk ahead of the
        one being read; stops at the chunk where EOS occurs.  With the
        ONNX codec a chunk carries codes only, and the decoder graph
        decodes them when the chunk is read, flushed at the last chunk
        (EOS in it, or no chunk after it).  Records
        ttft_ms (start to the first non-empty chunk read) and chunk_ms
        (between chunk reads); QTTS_TIMING=1 prints the prefill's and the
        first chunk's times, each after a device synchronize."""
        cfg = self.config
        spf = cfg.codec_decoder.samples_per_frame
        n_chunk = cfg.runtime.frames_per_chunk
        first_n = cfg.runtime.first_chunk_frames
        metrics = GenerationMetrics()
        watch = Stopwatch()
        t_start = time.perf_counter()
        timing = os.environ.get("QTTS_TIMING")

        def tlog(msg):
            if timing:
                self._sync()
                print(f"[qtts-timing] {msg}: {watch.elapsed_ms():.0f} ms "
                      f"(t+{(time.perf_counter() - t_start) * 1000:.0f} ms)",
                      flush=True)

        with self.device_lock:
            state, bucket = self._start_state(plan, self._torch_generator())
            tlog("prefill")
            self._sync()
        sampler = SamplerParams.make(self.sampler_config)
        codec = self.codec
        cs = codec.new_state(1)
        metrics.prefill_ms = watch.lap_ms()
        slots = _HostSlots(self.device, 1, max(first_n, n_chunk),
                           codec.wav_spf)
        codes_out = []
        steps = 0
        pending = None                       # the chunk enqueued last
        while True:
            nxt = None
            if steps < self.max_steps:
                n = min(n_chunk, self.max_steps - steps)
                if steps == 0 and 0 < first_n < n:
                    n = first_n              # small first chunk
                with self.device_lock:
                    state, cs, codes, valid, wav = codec.chunk(
                        state, cs, sampler, prompt_cap=bucket, n_frames=n)
                    nxt = slots.put(wav, valid, codes, n)
                if steps == 0:
                    tlog("lm + codec chunk 0")
                steps += n
            if pending is not None:
                wav_h, valid_h, codes_h, n0 = _HostSlots.get(pending)
                n_valid = int(valid_h[0].sum())
                metrics.chunk_ms.append(watch.lap_ms())
                if n_valid > 0:
                    with self.device_lock:
                        piece = codec.audio(wav_h, codes_h, [n_valid], cs,
                                            [n_valid < n0 or nxt is None])[0]
                    if metrics.ttft_ms is None:
                        metrics.ttft_ms = (time.perf_counter()
                                           - t_start) * 1000.0
                    codes_out.append(codes_h[0, :n_valid].copy())
                    yield piece
                if n_valid < n0:     # EOS in this chunk: drop the one ahead
                    metrics.eos = True
                    break
            pending = nxt
            if pending is None:
                break

        frames = sum(len(c) for c in codes_out)
        self.last_codes = (np.concatenate(codes_out) if codes_out else
                           np.zeros((0, P.NUM_CODEBOOKS), np.int32))
        metrics.total_ms = (time.perf_counter() - t_start) * 1000.0
        metrics.frames = frames
        metrics.audio_seconds = frames * spf / P.SAMPLE_RATE
        self.last_metrics = metrics
        log_event("generation", **metrics.as_dict())


class _HostSlots:
    """Two host slots for a stream's one-chunk lookahead, pinned on a CUDA
    device: `put` starts non-blocking copies of a chunk's wav [B, n * spf],
    valid [B, n] and codes [B, n, 16] into the next slot and records an
    event after them, so that `get` waits for that chunk alone and not for
    the chunk enqueued after it.  A slot is reused two chunks later: copy
    what `get` returns before then."""

    def __init__(self, device: torch.device, batch: int, n_frames: int,
                 spf: int):
        pin = device.type == "cuda"
        self.slots = [tuple(torch.empty(batch * n_frames * w, dtype=dt,
                                        pin_memory=pin)
                            for w, dt in ((spf, torch.float32),
                                          (1, torch.bool),
                                          (P.NUM_CODEBOOKS, torch.int32)))
                      for _ in range(2)]
        self.k = 0

    def put(self, wav: torch.Tensor, valid: torch.Tensor,
            codes: torch.Tensor, n: int):
        slot = self.slots[self.k % 2]
        self.k += 1
        host = [buf[: t.numel()].view(t.shape).copy_(t, non_blocking=True)
                for buf, t in zip(slot, (wav, valid, codes))]
        event = None
        if wav.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(wav.device))
        return host, event, n

    @staticmethod
    def get(pending):
        """(wav, valid, codes numpy views of the slot, n frames) once the
        chunk's copies have landed."""
        host, event, n = pending
        if event is not None:
            event.synchronize()
        return (*(t.numpy() for t in host), n)


_SENTENCE_ENDS = set(".!?;。！？；…\n")


def split_sentences(text: str, max_chars: int = 120) -> List[str]:
    """Greedy sentence-boundary chunking for long text (JAX
    engine.split_sentences): a piece ends after sentence punctuation once
    it has 4 characters, or at max_chars."""
    pieces, cur = [], []
    count = 0
    for ch in text:
        cur.append(ch)
        count += 1
        if (ch in _SENTENCE_ENDS and count >= 4) or count >= max_chars:
            pieces.append("".join(cur).strip())
            cur, count = [], 0
    if cur and "".join(cur).strip():
        pieces.append("".join(cur).strip())
    return [p for p in pieces if p]
