"""TtsEngine: the top-level facade.  Counterpart of qwen3_tts_tpu/engine.py,
for the preset-voice synthesis path:

    engine = TtsEngine(device="cuda")
    engine.set_max_steps(512); engine.set_sampler_config(SamplerConfig(...))
    audio = engine.generate_with_voice(text, engine.get_speaker("vivian"))

A request is one prompt plan, assembled and prefilled on the device, then
the bulk loop (runtime/generate._gen_bulk) over 4-frame chunks, each
decoded to audio by the native codec, with an early exit at EOS.

No weight files are read yet: without `weights`, every model runs on
deterministic random weights (development mode) at the configured widths,
and the engine says so loudly.  Streaming, voice cloning from audio, the
ONNX codec and the prompt-prefix KV cache are not ported yet and raise
NotImplementedError.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from .core import protocol as P
from .core.config import EngineConfig, SamplerConfig
from .io.assets import Assets
from .io.audio import AudioSample
from .io.voice_file import VoiceFile
from .models import predictor as predictor_lib
from .models import talker as talker_lib
from .models.codec import decoder as codec_decoder
from .models.transformer import dtype_of
from .prompt import PromptBuilder, PromptPlan
from .runtime.generate import Generator, SamplerParams
from .utils.logging import get_logger, log_event
from .utils.metrics import GenerationMetrics, Stopwatch
from .utils.tokenizer import Tokenizer


class PromptTooLongError(ValueError):
    """Prompt exceeds the static prefill capacity."""


# EngineConfig fields the port does not read (see core/config.py), by
# sub-config ("" = EngineConfig itself)
IGNORED_FIELDS = {
    "talker": ("flash_decode", "layer_scan_unroll"),
    "predictor": ("flash_decode", "layer_scan_unroll"),
    "runtime": ("first_chunk_frames", "batch_size", "mesh_shape",
                "mesh_axes", "donate_cache"),
    "": ("int8_weights",),
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


def set_cuda_precision() -> None:
    """f32 matmuls and convolutions on the card in full f32: no TF32.
    The JAX package computes the projection, the heads and the codec's
    convolutions with f32 accumulation of f32 (or bf16-exact) inputs;
    cuDNN would otherwise run the codec's f32 convolutions in TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class TtsEngine:
    """Owns the models, assets, tokenizer and speakers of one device."""

    def __init__(self, model_dir="models", config: Optional[EngineConfig] = None,
                 init_seed: int = 0, speakers_dir=None, device="cuda",
                 weights: Optional[Dict] = None):
        """weights: optional {"assets": Assets, "talker", "predictor",
        "codec_decoder": param dicts} already on `device` (io/from_jax
        builds them from the JAX package's arrays); None draws random
        development weights from `init_seed`."""
        self.device = torch.device(device)
        if self.device.type == "cuda":
            set_cuda_precision()
        self.model_dir = Path(model_dir)
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

        if weights is None:
            weights = self._random_weights(init_seed)
            self._warn_dev_mode()
        self.assets: Assets = weights["assets"]
        self.talker_params = weights["talker"]
        self.predictor_params = weights["predictor"]
        self.codec_decoder_params = weights["codec_decoder"]
        self.tokenizer = Tokenizer.load(self.model_dir)
        self.generator = Generator(self.config, self.talker_params,
                                   self.predictor_params, self.assets.pack(),
                                   codec_params=self.codec_decoder_params)

        for cand in ([Path(speakers_dir)] if speakers_dir else
                     [self.model_dir / "preset_speakers", Path("speakers")]):
            if cand.exists():
                self.load_speakers(cand)
                break

    def _random_weights(self, seed: int) -> Dict:
        cfg = self.config
        with torch.no_grad():
            gens = [torch.Generator(device=self.device).manual_seed(seed + i)
                    for i in range(4)]
            return {
                "assets": Assets.random_init(
                    gens[0], dtype=dtype_of(cfg.talker.dtype)),
                "talker": talker_lib.init_talker_params(cfg.talker, gens[1]),
                "predictor": predictor_lib.init_predictor_params(
                    cfg.predictor, gens[2]),
                "codec_decoder": codec_decoder.init_decoder_params(
                    cfg.codec_decoder, gens[3]),
            }

    def _warn_dev_mode(self) -> None:
        """Loudly flag random weights: synthesis is noise, not speech."""
        get_logger().warning(
            "DEV MODE: qwen3_tts_tpu_torch does not load weight files yet; "
            "assets, talker, predictor and codec decoder run on random "
            "weights — synthesis will be NOISE, not speech.")

    # ------------------------------------------------------------------ API
    def set_max_steps(self, steps: int) -> None:
        """Set the frame budget.  Above the runtime config's max_steps the
        config grows with it (the KV capacity derives from it)."""
        import dataclasses
        steps = int(steps)
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
        raise NotImplementedError("voice cloning from reference audio is "
                                  "not yet ported")

    def create_voice_file(self, audio_path, ref_text: str) -> VoiceFile:
        raise NotImplementedError("voice cloning from reference audio is "
                                  "not yet ported")

    def generate_stream(self, text: str, voice: VoiceFile,
                        instruct: Optional[str] = None):
        raise NotImplementedError("streaming synthesis is not yet ported")

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

    def _start_state(self, plan: PromptPlan, generator: torch.Generator):
        """Assembly + prefill of one plan (no prefix-KV reuse yet).
        Returns (GenState, bucket)."""
        a, lengths, bucket = self._plans_to_arrays(plan)
        dev = self.device
        t = {k: torch.from_numpy(v).to(dev) for k, v in a.items()}
        state = self.generator.start_from_plans(
            self.assets.text_table, self.assets.codec_tables, t["text_idx"],
            t["codec_idx"], t["frame_slot"], t["spk_flag"], t["frames"],
            t["spk_emb"], torch.from_numpy(lengths).to(dev), generator)
        return state, bucket

    @torch.no_grad()
    def _run_inference(self, plan: PromptPlan) -> AudioSample:
        """Non-streaming synthesis: prefill, then the bulk chunk loop with
        the codec decode of each chunk; early exit at EOS."""
        cfg = self.config
        spf = cfg.codec_decoder.samples_per_frame
        metrics = GenerationMetrics()
        watch = Stopwatch()
        t_start = time.perf_counter()
        seed = self.sampler_config.seed
        if seed is None:
            seed = time.time_ns() & 0x7FFFFFFFFFFFFFFF
        gen = torch.Generator(device=self.device).manual_seed(seed)

        state, bucket = self._start_state(plan, gen)
        sampler = SamplerParams.make(self.sampler_config)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        metrics.prefill_ms = watch.lap_ms()
        max_frames = min(self.max_steps, cfg.runtime.max_steps)
        dec_state = codec_decoder.init_decoder_state(cfg.codec_decoder, 1,
                                                     self.device)
        (state, dec_state, codes, valid, wav, _,
         saw_eos) = self.generator.run_bulk(state, dec_state, sampler,
                                            prompt_cap=bucket,
                                            max_frames=max_frames)
        n_valid = int(valid[0].sum())
        metrics.eos = bool(saw_eos[0])
        samples = wav[0, : n_valid * spf].cpu().numpy()
        self.last_codes = codes[0, :n_valid].cpu().numpy()

        metrics.total_ms = (time.perf_counter() - t_start) * 1000.0
        metrics.ttft_ms = None       # a streaming metric
        metrics.frames = n_valid
        metrics.audio_seconds = n_valid * spf / P.SAMPLE_RATE
        self.last_metrics = metrics
        log_event("generation", **metrics.as_dict())
        return AudioSample(samples=samples, sample_rate=P.SAMPLE_RATE,
                           channels=1)
