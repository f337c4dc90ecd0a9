"""TtsEngine: the top-level facade.  Counterpart of qwen3_tts_tpu/engine.py,
for the preset-voice synthesis path:

    engine = TtsEngine("models", quant="q8_0", device="cuda")
    engine.set_max_steps(512); engine.set_sampler_config(SamplerConfig(...))
    audio = engine.generate_with_voice(text, engine.get_speaker("vivian"))

A request is one prompt plan, assembled and prefilled on the device, then
the bulk loop (runtime/generate._gen_bulk) over 4-frame chunks, each
decoded to audio by the native codec, with an early exit at EOS.

Weights, in the JAX engine's order (qwen3_tts_tpu/engine.py), from
`model_dir` in the published layout: the assets
(`<weights dir>/qwen3_assets.gguf`, io/assets), the tokenizer, the talker
and predictor (`qwen3_tts_talker.gguf`, `qwen3_tts_predictor.gguf`,
io/weights: dims from the GGUF metadata), the codec decoder
(`codec/decoder.npz`).  The weights dir is `gguf/` for quant="none",
`gguf_q5_k_m/` / `gguf_q8_0/` for "q5_k_m" / "q8_0" (QUANT_DIRS).  A
component without its file runs on deterministic random weights
(development mode) at the configured widths, and the engine says so
loudly.  EngineConfig.int8_weights (None: quant != "none") quantizes the
talker's and predictor's layers and heads to int8 device weights
(ops.quant).  With weight_cache=True (the JAX package's QTTS_WEIGHT_CACHE)
the converted talker and predictor are saved under `model_dir/cache/`
(io/checkpoint) and read back by later engines.  `weights=` hands the
components in directly (io/from_jax builds them from the JAX package's
arrays) and reads no file.

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
QTTS_A8_PREFILL).  Streaming, voice cloning from audio, the ONNX codec
and the prompt-prefix KV cache are not ported yet and raise
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
from .io import checkpoint as ckpt_io
from .io import weights as weights_io
from .io.assets import Assets
from .io.audio import AudioSample
from .io.voice_file import VoiceFile
from .models import predictor as predictor_lib
from .models import talker as talker_lib
from .models.codec import decoder as codec_decoder
from .models.transformer import dtype_of
from .ops import quant as quant_ops
from .prompt import PromptBuilder, PromptPlan, assemble
from .runtime.generate import (CHUNK_BATCHES, Generator, SamplerParams,
                               chunk_unsupported, fused_unsupported)
from .utils.logging import get_logger, log_event
from .utils.metrics import GenerationMetrics, Stopwatch
from .utils.tokenizer import Tokenizer


class PromptTooLongError(ValueError):
    """Prompt exceeds the static prefill capacity."""


QUANT_DIRS = {"q5_k_m": "gguf_q5_k_m", "q8_0": "gguf_q8_0"}

# EngineConfig fields the port does not read (see core/config.py), by
# sub-config ("" = EngineConfig itself)
IGNORED_FIELDS = {
    "talker": ("flash_decode", "layer_scan_unroll"),
    "predictor": ("flash_decode", "layer_scan_unroll"),
    "runtime": ("first_chunk_frames", "batch_size", "mesh_shape",
                "mesh_axes", "donate_cache"),
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
                 weights: Optional[Dict] = None,
                 fused: Optional[bool] = None,
                 chunk: Optional[bool] = None, quant: str = "none",
                 talker_mode: str = "w4a8", a8_prefill: bool = True,
                 weight_cache: bool = True):
        """model_dir, quant: where the weights are read (module docstring);
        weights: optional {"assets": Assets, "talker", "predictor",
        "codec_decoder": param dicts} already on `device`, read instead of
        any file; init_seed: the seed of development weights.  fused,
        chunk, talker_mode: the decode path (module docstring); None,
        None = the chunk path on a CUDA device, the exact path on the CPU.
        a8_prefill: a8w8 prompt prefill on int8 weights.  weight_cache:
        save and read the converted talker and predictor under
        model_dir/cache/."""
        self.device = torch.device(device)
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
        self.assets: Assets = weights["assets"]
        self.talker_params = weights["talker"]
        self.predictor_params = weights["predictor"]
        self.codec_decoder_params = weights["codec_decoder"]
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

        for cand in ([Path(speakers_dir)] if speakers_dir else
                     [self.model_dir / "preset_speakers", Path("speakers")]):
            if cand.exists():
                self.load_speakers(cand)
                break

    def _load_weights(self, seed: int, use_int8: bool,
                      weight_cache: bool) -> Dict:
        """Every component from its file under model_dir, or random
        (module docstring), in the JAX engine's order; self.config takes
        the GGUF metadata's dims."""
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

        path = self.model_dir / "codec" / "decoder.npz"
        out["codec_decoder"] = (
            load_npz(path, dev, dtype_of(cfg.codec_decoder.dtype))
            if path.exists() else
            self._random_component("codec_decoder", seed))
        self._warn_dev_mode()
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
        i = ("assets", "talker", "predictor", "codec_decoder").index(name)
        g = torch.Generator(device=self.device).manual_seed(seed + i)
        with torch.no_grad():
            if name == "assets":
                return Assets.random_init(g, dtype=dtype_of(cfg.talker.dtype))
            if name == "talker":
                return talker_lib.init_talker_params(cfg.talker, g)
            if name == "predictor":
                return predictor_lib.init_predictor_params(cfg.predictor, g)
            return codec_decoder.init_decoder_params(cfg.codec_decoder, g)

    def _warn_dev_mode(self) -> None:
        """Loudly flag components on random weights: synthesis is noise."""
        if not self.dev_mode_components:
            return
        get_logger().warning(
            f"DEV MODE: no trained weights found for "
            f"[{', '.join(self.dev_mode_components)}] under "
            f"{self.model_dir} (quant={self.quant!r}) — synthesis will be "
            "NOISE, not speech.  Place the model files (gguf*/*.gguf, "
            "codec/decoder.npz) in the model dir.")

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

    def _start_state(self, plan: PromptPlan, generator: torch.Generator):
        """Assembly + prefill of one plan (no prefix-KV reuse yet).
        Returns (GenState, bucket)."""
        state, _, bucket = self.start_plans(plan, None, generator)
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


def load_npz(path, device="cpu", dtype=None):
    """A nested dict / list of tensors on `device` from an npz whose keys
    are 'a/b/0/c' paths (the JAX engine's `_unflatten_npz`); floating
    arrays in `dtype` when given (the codec decoder holds every parameter
    in its config's dtype)."""
    tree: Dict = {}
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            parts = key.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            t = torch.from_numpy(np.array(data[key])).to(device)
            if dtype is not None and t.is_floating_point():
                t = t.to(dtype)
            node[parts[-1]] = t

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [fix(node[str(i)]) for i in range(len(node))]
        return {k: fix(v) for k, v in node.items()}

    return fix(tree)
