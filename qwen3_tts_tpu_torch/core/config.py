"""Copy of qwen3_tts_tpu/core/config.py: the port cannot import the JAX package,
whose __init__ imports jax.  Keep the two in step.

The port does not read these fields: the TPU routing switches
TalkerConfig/PredictorConfig.flash_decode and layer_scan_unroll, and
RuntimeConfig.mesh_shape, mesh_axes and donate_cache (on a CUDA tensor the
port always runs its own attention kernels, on one device);
RuntimeConfig.batch_size (the serving classes take their batch size as an
argument).  RuntimeConfig.first_chunk_frames is read as in the JAX
package: the frames of a stream's first chunk (TtsEngine.generate_stream,
stream_batch; 0: a whole chunk).  TtsEngine refuses a config that
sets any of them away from its default (engine.IGNORED_FIELDS), so that
setting one is never a silent no-op.  EngineConfig.int8_weights is read
as in the JAX package: int8 device weights for the talker and predictor
(None: when TtsEngine's quant is not "none"); the fused decode kernels
pack their own weights from bf16 or int8 weights (TtsEngine's `fused`,
`chunk` and `talker_mode` select the path, not this field).

Configuration dataclasses for the TPU-native Qwen3-TTS framework.

One frozen dataclass per subsystem; `EngineConfig` aggregates them.  The
reference hardcodes most of this (ctx sizes at engine.rs:133-136, sampler at
engine.rs:14-45); here everything is explicit and overridable, with
`tiny()` constructors used by the test-suite so the full pipeline runs on a
CPU in milliseconds.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

from . import protocol as P


@dataclass(frozen=True)
class SamplerConfig:
    """Sampling parameters for the talker code_0 head.

    Mirrors the reference `SamplerConfig` (engine.rs:14-45): temperature 0
    means greedy; top_k 0 disables the top-k filter; top_p 1.0 disables
    nucleus filtering; seed None draws one from OS entropy at generation time.
    """

    temperature: float = 0.7
    top_k: int = 40
    top_p: float = 0.9
    seed: Optional[int] = None

    def replace(self, **kw) -> "SamplerConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TalkerConfig:
    """Qwen3 decoder that consumes 2048-d prompt embeddings and emits
    codebook-0 logits.  GQA + RMSNorm(+qk-norm) + SwiGLU + M-RoPE."""

    d_model: int = 2048
    n_layers: int = 28
    n_heads: int = 16
    n_kv_heads: int = 8
    head_dim: int = 128
    d_ff: int = 6144
    rms_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    # M-RoPE frequency sections (in half-dims, summing to head_dim // 2) for
    # the 4 position rows (temporal, height, width, channel), laid out as
    # CONTIGUOUS blocks like llama.cpp's GGML mrope (llama/mod.rs:567-581).
    # Overridden by `qwen3.rope.mrope_section` GGUF metadata when a real
    # checkpoint is loaded (io/weights.py:config_from_gguf).  The reference
    # feeds T=H=W=arange and channel=0 (engine.rs:306-314), so with a zero
    # channel section ANY split is numerically identical to standard RoPE —
    # tested in tests/test_ops.py.
    mrope_sections: Tuple[int, int, int, int] = (24, 20, 20, 0)
    qk_norm: bool = True
    n_codec_logits: int = P.CODE_SAMPLING_LIMIT  # LM-head rows kept: [0, 2160)
    max_seq_len: int = 4096
    dtype: str = "bfloat16"
    flash_decode: bool = True   # Pallas decode-attention kernel on TPU
    layer_scan_unroll: int = 1  # 28 layers: keep the compact scan program

    @staticmethod
    def tiny() -> "TalkerConfig":
        return TalkerConfig(
            d_model=P.TALKER_DIM,  # protocol-fixed: prompt embeds are 2048-d
            n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=64,
            mrope_sections=(3, 3, 2, 0),
            n_codec_logits=P.CODE_SAMPLING_LIMIT, max_seq_len=256,
            dtype="float32",
        )


@dataclass(frozen=True)
class PredictorConfig:
    """Small Qwen3 decoder expanding each talker step into the 15 residual
    codes.  Vocab is 15 codebooks x 2048 concatenated; context is at most
    2 (prefill) + 14 (inner steps) tokens (engine.rs:570-611)."""

    d_model: int = 1024
    n_layers: int = 6
    n_heads: int = 16
    n_kv_heads: int = 8
    head_dim: int = 64
    d_ff: int = 3072
    rms_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    qk_norm: bool = True
    n_residual_codebooks: int = P.NUM_CODEBOOKS - 1
    codebook_size: int = P.CODEBOOK_SIZE
    max_seq_len: int = 16
    dtype: str = "bfloat16"
    # The per-frame cache is 17 slots; a chunked HBM-streaming kernel would
    # read more than XLA does, so the predictor keeps the fused XLA path.
    flash_decode: bool = False
    # NOTE: unrolling the 6-layer scan speeds the predictor in isolation
    # (4.1 -> 3.0 ms/frame) but regresses the big fused chunk program
    # (single-stream RTF 0.090 -> 0.116 measured) — the inlined body blows
    # up the fused program's scheduling.  Keep the compact scan.
    layer_scan_unroll: int = 1

    @property
    def vocab_size(self) -> int:
        return self.n_residual_codebooks * self.codebook_size

    @staticmethod
    def tiny() -> "PredictorConfig":
        return PredictorConfig(
            d_model=P.PREDICTOR_DIM, n_layers=2, n_heads=4, n_kv_heads=2,
            head_dim=16, d_ff=64, dtype="float32",
        )


@dataclass(frozen=True)
class CodecDecoderConfig:
    """Streaming codec decoder: codes -> 24 kHz waveform.

    8-layer/16-head/d_head-64 latent transformer over summed codebook
    embeddings, then a causal conv-transpose upsampler (total factor
    prod(upsample_factors) == SAMPLES_PER_FRAME).  All state (conv histories +
    KV ring) has static shapes so chunked streaming decode is bit-identical to
    full decode.  State signature parity: the reference's src/models/onnx.rs:461-496.
    """

    d_model: int = 1024
    n_layers: int = 8
    n_heads: int = 16
    head_dim: int = 64
    d_ff: int = 4096
    rms_eps: float = 1e-6
    rope_theta: float = 10_000.0
    n_codebooks: int = P.NUM_CODEBOOKS
    codebook_size: int = P.CODEBOOK_SIZE
    upsample_factors: Tuple[int, ...] = (5, 5, 4, 4, 5)  # prod = 2000
    channels: Tuple[int, ...] = (1024, 512, 256, 128, 64)
    conv_kernel: int = 7
    # Conv-transpose kernel width as a multiple of the stride.  1 = kernel
    # == stride (no cross-input overlap, stateless stages — the fast
    # default).  m > 1 = kernel == m*stride (BigVGAN/DAC-style overlapping
    # transpose): streamed causally with a carried (m-1)*stride-sample
    # overlap-add tail per stage, still exactly chunk-invariant — so if the
    # real checkpoint's graph (onnx.rs:355-458) overlaps, the fused native
    # path fits it instead of falling back to onnx_exec (VERDICT r3 #7).
    upsample_kernel_mult: int = 1
    attn_window: int = 128  # sliding-window latent attention capacity (frames)
    dtype: str = "bfloat16"

    @property
    def samples_per_frame(self) -> int:
        out = 1
        for f in self.upsample_factors:
            out *= f
        return out

    @staticmethod
    def tiny() -> "CodecDecoderConfig":
        return CodecDecoderConfig(
            d_model=32, n_layers=2, n_heads=2, head_dim=16, d_ff=64,
            upsample_factors=(2, 2), channels=(16, 8), conv_kernel=3,
            attn_window=8, dtype="float32",
        )


@dataclass(frozen=True)
class CodecEncoderConfig:
    """Codec encoder: 24 kHz waveform -> [frames, 16] RVQ codes."""

    d_model: int = 1024
    downsample_factors: Tuple[int, ...] = (5, 4, 4, 5, 5)  # prod = 2000
    channels: Tuple[int, ...] = (64, 128, 256, 512, 1024)
    conv_kernel: int = 7
    # Per-stage strided-conv kernel = stage_kernel_mult * stride.  Config,
    # not hardcode, so a real checkpoint with a different receptive field
    # imports into the fast native path instead of forcing a permanent
    # onnx_exec fallback (the decoder's upsample_kernel_mult analogue —
    # io.codec_import.infer_encoder_geometry detects it from the export).
    stage_kernel_mult: int = 2
    n_codebooks: int = P.NUM_CODEBOOKS
    codebook_size: int = P.CODEBOOK_SIZE
    dtype: str = "float32"

    @staticmethod
    def tiny() -> "CodecEncoderConfig":
        return CodecEncoderConfig(
            d_model=32, downsample_factors=(2, 2), channels=(8, 32),
            conv_kernel=3,
        )


@dataclass(frozen=True)
class SpeakerEncoderConfig:
    """Speaker encoder: log-mel [frames, 128] -> 2048-d speaker embedding.

    Mel front-end parameters match the reference exactly
    (onnx.rs:170-176): 24 kHz, n_fft 1024, hop 256, 128 Slaney mels,
    fmin 0, fmax 12000, reflect pad, Hann window, log(max(mel, 1e-5)).
    """

    n_mels: int = 128
    n_fft: int = 1024
    hop_length: int = 256
    fmin: float = 0.0
    fmax: float = 12_000.0
    sample_rate: int = P.SAMPLE_RATE
    d_model: int = 256
    n_layers: int = 4
    emb_dim: int = P.SPEAKER_EMB_DIM
    # "attentive" (ECAPA-style attentive statistics) or "xvector" (plain
    # mean/std statistics pooling).  Selectable so a real checkpoint of
    # either family imports into the native fast path
    # (io.codec_import.infer_speaker_pooling detects which from the export).
    pooling: str = "attentive"
    dtype: str = "float32"

    @staticmethod
    def tiny() -> "SpeakerEncoderConfig":
        return SpeakerEncoderConfig(d_model=16, n_layers=1)


@dataclass(frozen=True)
class RuntimeConfig:
    """Generation-loop / serving parameters."""

    max_steps: int = 512                 # frames; ~42 s of audio at 12 fps
    frames_per_chunk: int = P.FRAMES_PER_CHUNK
    # Streaming emits a smaller first chunk to cut TTFT (~83 ms of audio per
    # frame); 0 disables the fast first chunk.  One frame: at batch 32 the
    # 2-frame first chunk was the ~10 ms that kept p50 TTFT above the
    # 150 ms target; chunk boundaries are bit-invariant (ring codec), so
    # the only cost is one extra early host dispatch.
    first_chunk_frames: int = 1
    # Static prefill capacity (padded).  Matches the reference talker's
    # n_ctx=4096 (engine.rs:133): a ~30 s clone reference (~360 frame rows)
    # plus instruction + task text fits without truncation.
    max_prompt_len: int = 4096
    batch_size: int = 1                  # concurrent streams per device group
    mesh_shape: Tuple[int, ...] = (1,)   # (data,) or (data, model)
    mesh_axes: Tuple[str, ...] = ("data",)
    donate_cache: bool = True


@dataclass(frozen=True)
class EngineConfig:
    talker: TalkerConfig = field(default_factory=TalkerConfig)
    predictor: PredictorConfig = field(default_factory=PredictorConfig)
    codec_decoder: CodecDecoderConfig = field(default_factory=CodecDecoderConfig)
    codec_encoder: CodecEncoderConfig = field(default_factory=CodecEncoderConfig)
    speaker_encoder: SpeakerEncoderConfig = field(default_factory=SpeakerEncoderConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    text_vocab_size: int = 151_936
    lang_id: int = P.DEFAULT_LANG_ID
    # int8 device weights for the two LMs (halves the HBM stream that sets
    # decode latency).  None = follow the `quant` argument of the engine
    # (quantized GGUF source -> int8 device weights).
    int8_weights: Optional[bool] = None

    @staticmethod
    def tiny() -> "EngineConfig":
        return EngineConfig(
            talker=TalkerConfig.tiny(),
            predictor=PredictorConfig.tiny(),
            codec_decoder=CodecDecoderConfig.tiny(),
            codec_encoder=CodecEncoderConfig.tiny(),
            speaker_encoder=SpeakerEncoderConfig.tiny(),
            runtime=RuntimeConfig(max_steps=16, max_prompt_len=64),
            text_vocab_size=P.EOS_TOKEN + 1,
        )

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------- structured config IO
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(data: dict) -> "EngineConfig":
        """Build from a (possibly partial) nested dict: unknown keys raise,
        missing keys keep defaults.  The inverse of to_dict()."""
        base = EngineConfig()
        sub = {f.name: f.type for f in dataclasses.fields(EngineConfig)}
        kw = {}
        for key, val in data.items():
            if key not in sub:
                raise ValueError(f"unknown EngineConfig field {key!r}")
            cur = getattr(base, key)
            if dataclasses.is_dataclass(cur) and isinstance(val, dict):
                names = {f.name for f in dataclasses.fields(cur)}
                bad = set(val) - names
                if bad:
                    raise ValueError(f"unknown {key} fields {sorted(bad)}")
                fixed = {k: tuple(v) if isinstance(v, list) else v
                         for k, v in val.items()}
                kw[key] = dataclasses.replace(cur, **fixed)
            else:
                kw[key] = val
        return base.replace(**kw)

    @staticmethod
    def from_file(path) -> "EngineConfig":
        """Load a json or toml config file (the reference hardcodes its
        engine parameters; here they are data, SURVEY §5 config row)."""
        from pathlib import Path
        path = Path(path)
        text = path.read_text()
        if path.suffix == ".toml":
            import tomllib
            return EngineConfig.from_dict(tomllib.loads(text))
        import json
        return EngineConfig.from_dict(json.loads(text))
