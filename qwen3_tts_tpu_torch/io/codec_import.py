"""ONNX-initializer -> native-codec weight import.  Counterpart of
qwen3_tts_tpu/io/codec_import.py.

The published model directory ships the codec as ONNX graphs (decoder,
audio encoder, speaker encoder under `onnx/`).  The engine runs them
directly (models/codec/onnx_decoder); the fast path is the native decoder
(models/codec/decoder.py), which needs the graph's initializers mapped
into the native parameter tree:

  1. `param_spec(init_fn, cfg)`: the {path: (shape, dtype)} contract of a
     native model, from its init function run on the `meta` device (no
     weight allocated).
  2. `decoder_name_map(cfg)` (and the encoder and speaker maps): best-guess
     source names for a torch-exported graph.  When the real file
     disagrees, list it with `python -m qwen3_tts_tpu_torch.io.convert
     model.onnx --list` and edit the entries; every mistake fails loudly.
  3. `infer_name_map(initializers, spec)`: shape-based matching for
     opaquely named exports; ambiguities and leftovers are reported, not
     guessed.
  4. `convert_codec(initializers, cfg, ...)`: the tree with per-tensor
     validation: a missing source, a wrong shape or a non-finite tensor
     raises CodecImportError naming every offending entry.
  5. `validate_decoder_against_onnx(...)`: the port's native decoder and
     the ONNX graph (io.onnx_exec) on the same random codes, waveforms
     compared; square matrices make transpose conventions undetectable by
     shape, and this check settles them.

The flattened output (io.convert.flatten_pytree) is what
`model_dir/codec/decoder.npz` holds, the same file the JAX package's
importer writes from the same initializers.  `infer_speaker_pooling` does
not copy the JAX importer's fault: there any [d, d] tensor reads as the
attentive score head, so an x-vector export with n_mels == d (its
in-projection square) comes out attentive.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Transform = Optional[Union[str, Callable[[np.ndarray], np.ndarray]]]
# one source tensor, or a list to stack on a new leading axis
Entry = Union[Tuple[str, Transform], List[Tuple[str, Transform]]]

# numpy's dtype for each parameter dtype (numpy has no bfloat16: float32,
# which TtsEngine's npz reader casts back to the config's dtype)
_NP_DTYPES = {torch.float32: np.float32, torch.float16: np.float16,
              torch.bfloat16: np.float32, torch.int32: np.int32,
              torch.int64: np.int64}


class CodecImportError(RuntimeError):
    """Raised with a full per-tensor report; never partial-succeeds."""


class _MetaGenerator(torch.Generator):
    """A generator whose device is `meta`: the init functions draw on its
    device, so every parameter is a shape without storage."""
    device = torch.device("meta")


# --------------------------------------------------------------------------
def param_spec(init_fn, cfg) -> Dict[str, Tuple[Tuple[int, ...], Any]]:
    """Flat {path: (shape, numpy dtype)} of a native codec model's
    parameters (init_fn(cfg, generator) run on the meta device)."""
    params = init_fn(cfg, _MetaGenerator())
    flat = {}

    def walk(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}{k}/")
        elif isinstance(tree, (tuple, list)):
            for i, v in enumerate(tree):
                walk(v, f"{prefix}{i}/")
        else:
            flat[prefix[:-1]] = (tuple(tree.shape),
                                 np.dtype(_NP_DTYPES[tree.dtype]))

    walk(params)
    return flat


def _apply(t: np.ndarray, tf: Transform) -> np.ndarray:
    if tf is None:
        return t
    if tf == "T":
        return np.ascontiguousarray(np.swapaxes(t, -1, -2))
    if tf == "conv_t":              # torch ConvTranspose1d [in, out, K] ->
        return np.ascontiguousarray(np.swapaxes(t, 0, 1))  # [out, in, K]
    return tf(t)


def decoder_name_map(cfg) -> Dict[str, Entry]:
    """Best-guess source names for a torch-export of the streaming decoder
    (the graph behind onnx/qwen3_tts_decoder.onnx).

    Conventions assumed (each is validated, not trusted):
      * torch Linear weights are stored [out, in] -> "T" into the native
        [in, out] matmul layout;
      * torch Conv1d weights [out, in, K] match natively; ConvTranspose1d
        [in, out, K] -> "conv_t";
      * per-layer tensors stack on a new leading [L] axis.
    Edit the right-hand names to the real file's listing; shapes and the
    ONNX cross-check do the rest.
    """
    L = cfg.n_layers
    m: Dict[str, Entry] = {
        "embed": [(f"quantizer.codebooks.{q}.weight", None)
                  for q in range(cfg.n_codebooks)],
        "final_norm": ("transformer.norm.weight", None),
        "pre_conv/w": ("pre_conv.weight", None),
        "pre_conv/b": ("pre_conv.bias", None),
        "out_conv/w": ("out_conv.weight", None),
        "out_conv/b": ("out_conv.bias", None),
    }
    per_layer = {
        "ln1": ("input_layernorm.weight", None),
        "ln2": ("post_attention_layernorm.weight", None),
        "wq": ("self_attn.q_proj.weight", "T"),
        "wk": ("self_attn.k_proj.weight", "T"),
        "wv": ("self_attn.v_proj.weight", "T"),
        "wo": ("self_attn.o_proj.weight", "T"),
        "w_gate": ("mlp.gate_proj.weight", "T"),
        "w_up": ("mlp.up_proj.weight", "T"),
        "w_down": ("mlp.down_proj.weight", "T"),
    }
    for key, (suffix, tf) in per_layer.items():
        m[f"layers/{key}"] = [(f"transformer.layers.{l}.{suffix}", tf)
                              for l in range(L)]
    for i in range(len(cfg.upsample_factors)):
        s = f"upsample_stages.{i}"
        m[f"stages/{i}/up_w"] = (f"{s}.up.weight", "conv_t")
        m[f"stages/{i}/up_b"] = (f"{s}.up.bias", None)
        m[f"stages/{i}/alpha1"] = (f"{s}.snake1.alpha", np.ravel)
        m[f"stages/{i}/conv1_w"] = (f"{s}.conv1.weight", None)
        m[f"stages/{i}/conv1_b"] = (f"{s}.conv1.bias", None)
        m[f"stages/{i}/alpha2"] = (f"{s}.snake2.alpha", np.ravel)
        m[f"stages/{i}/conv2_w"] = (f"{s}.conv2.weight", None)
        m[f"stages/{i}/conv2_b"] = (f"{s}.conv2.bias", None)
    return m


def encoder_name_map(cfg) -> Dict[str, Entry]:
    """Best-guess source names for a torch-export of the audio encoder
    (wav -> codes, the graph behind onnx/qwen3_tts_codec_encoder.onnx).
    Same conventions as decoder_name_map; every assumption is validated by
    convert_codec, so a wrong guess fails loudly with the tensor named."""
    m: Dict[str, Entry] = {
        "in_conv/w": ("in_conv.weight", None),
        "in_conv/b": ("in_conv.bias", None),
        "out_proj": ("out_proj.weight", "T"),
        "codebooks": [(f"quantizer.codebooks.{q}.weight", None)
                      for q in range(cfg.n_codebooks)],
    }
    for i in range(len(cfg.downsample_factors)):
        m[f"stages/{i}/w"] = (f"down_stages.{i}.weight", None)
        m[f"stages/{i}/b"] = (f"down_stages.{i}.bias", None)
    return m


def speaker_name_map(cfg) -> Dict[str, Entry]:
    """Best-guess source names for a torch-export of the speaker encoder
    (mel -> spk_emb, the graph behind onnx/qwen3_tts_speaker_encoder.onnx).  The
    attention value vector is torch Linear(d, 1).weight [1, d] -> ravel."""
    m: Dict[str, Entry] = {
        "in_proj": ("in_proj.weight", "T"),
        "head": ("head.weight", "T"),
    }
    if cfg.pooling == "attentive":
        m["attn_w"] = ("attention.w.weight", "T")
        m["attn_v"] = ("attention.v.weight", np.ravel)
    for i in range(cfg.n_layers):
        m[f"convs/{i}/w"] = (f"convs.{i}.weight", None)
        m[f"convs/{i}/b"] = (f"convs.{i}.bias", None)
    return m


@dataclass
class InferReport:
    assigned: Dict[str, Entry] = field(default_factory=dict)
    ambiguous: Dict[str, List[str]] = field(default_factory=dict)
    unmatched_spec: List[str] = field(default_factory=list)
    unused_inits: List[str] = field(default_factory=list)


def infer_name_map(initializers: Dict[str, np.ndarray],
                   spec: Dict[str, Tuple[Tuple[int, ...], Any]],
                   stacked_prefixes: Sequence[str] = ("layers/",),
                   ) -> InferReport:
    """Shape-match spec entries against initializer shapes.

    Handles opaquely named exports: an entry is assigned when its expected
    shape — or, for 2-D matrices, its transpose — matches exactly one unused
    initializer.  Stacked native arrays (leading [L] under a stacked prefix)
    match L same-shaped initializers in the file's declaration order (ONNX
    initializer order follows the module order of the exporter).  Anything
    ambiguous is reported for a human decision, never guessed.
    """
    by_shape: Dict[Tuple[int, ...], List[str]] = {}
    for name, t in initializers.items():
        by_shape.setdefault(tuple(t.shape), []).append(name)
    used: set = set()
    rep = InferReport()

    def take(shape, n=1):
        """Names with `shape` (preferring untransposed) not yet used."""
        cands = [nm for nm in by_shape.get(tuple(shape), [])
                 if nm not in used]
        return cands if len(cands) >= n else None

    for path, (shape, _) in sorted(spec.items()):
        stacked = any(path.startswith(p) for p in stacked_prefixes)
        if stacked:
            L, inner = shape[0], tuple(shape[1:])
            cands = take(inner, L)
            t_cands = (take(inner[::-1], L)
                       if len(inner) == 2 and inner[0] != inner[1] else None)
            if cands is not None and len(cands) == L and t_cands is None:
                used.update(cands)
                rep.assigned[path] = [(nm, None) for nm in cands]
            elif t_cands is not None and len(t_cands) == L and cands is None:
                used.update(t_cands)
                rep.assigned[path] = [(nm, "T") for nm in t_cands]
            elif cands or t_cands:
                rep.ambiguous[path] = (cands or []) + (t_cands or [])
            else:
                rep.unmatched_spec.append(path)
            continue
        cands = take(shape) or []
        t_cands = (take(shape[::-1]) or []
                   if len(shape) == 2 and shape[0] != shape[1] else [])
        if len(cands) == 1 and not t_cands:
            used.add(cands[0])
            rep.assigned[path] = (cands[0], None)
        elif len(t_cands) == 1 and not cands:
            used.add(t_cands[0])
            rep.assigned[path] = (t_cands[0], "T")
        elif cands or t_cands:
            rep.ambiguous[path] = cands + t_cands
        else:
            rep.unmatched_spec.append(path)
    rep.unused_inits = [nm for nm in initializers if nm not in used]
    return rep


def _upsample_weight(initializers, i, c_in, c_out) -> np.ndarray:
    name = f"upsample_stages.{i}.up.weight"
    t = initializers.get(name)
    if t is not None:
        return np.asarray(t)
    cands = [np.asarray(v) for v in initializers.values()
             if np.asarray(v).ndim == 3
             and np.asarray(v).shape[:2] == (c_in, c_out)]
    if len(cands) != 1:
        raise CodecImportError(
            f"stage {i}: cannot locate conv-transpose weight ('{name}' "
            f"absent, {len(cands)} shape candidates [{c_in}, {c_out}, *])")
    return cands[0]


def infer_upsample_mult(initializers: Dict[str, np.ndarray], cfg) -> int:
    """The conv-transpose kernel / stride ratio of a decoder export, so
    the native path can take overlapping geometry
    (models.codec.decoder.upsample_overlap).  Looks up each stage's
    `upsample_stages.{i}.up.weight` (torch ConvTranspose1d [in, out, K]),
    else shape-scans for [c_in, c_out, K].  Returns the uniform multiple m
    (kernel == m * stride); raises CodecImportError when stages disagree
    or a kernel is not a stride multiple (geometry the streaming path
    cannot carry: run the ONNX graph)."""
    from ..models.codec.decoder import _stage_channels
    mults = []
    for i, ((c_in, c_out), r) in enumerate(zip(_stage_channels(cfg),
                                               cfg.upsample_factors)):
        k = int(_upsample_weight(initializers, i, c_in, c_out).shape[-1])
        if k % r != 0:
            raise CodecImportError(
                f"stage {i}: transpose kernel {k} is not a multiple of "
                f"stride {r} — streaming overlap-add cannot carry it; "
                f"run this checkpoint's ONNX graph (io.onnx_exec)")
        mults.append(k // r)
    if len(set(mults)) != 1:
        raise CodecImportError(
            f"non-uniform transpose kernel/stride ratios {mults}; set "
            f"per-stage geometry manually or run the ONNX graph")
    return mults[0]


def infer_encoder_geometry(initializers: Dict[str, np.ndarray], cfg):
    """An audio-encoder export's strided-conv geometry: cfg with
    stage_kernel_mult set to the uniform kernel / stride multiple of its
    `down_stages.{i}.weight` (torch Conv1d [out, in, K]; else shape-scanned
    [c_out, c_in, K]); CodecImportError for a non-multiple or non-uniform
    geometry the causal framing cannot carry."""
    import dataclasses
    chans = list(cfg.channels)
    mults = []
    for i, r in enumerate(cfg.downsample_factors):
        c_in = chans[i]
        c_out = chans[min(i + 1, len(chans) - 1)]
        name = f"down_stages.{i}.weight"
        t = initializers.get(name)
        if t is None:
            cands = [np.asarray(v) for v in initializers.values()
                     if np.asarray(v).ndim == 3
                     and np.asarray(v).shape[:2] == (c_out, c_in)]
            if len(cands) != 1:
                raise CodecImportError(
                    f"encoder stage {i}: cannot locate strided-conv weight "
                    f"('{name}' absent, {len(cands)} shape candidates "
                    f"[{c_out}, {c_in}, *])")
            t = cands[0]
        k = int(np.asarray(t).shape[-1])
        if k % r != 0:
            raise CodecImportError(
                f"encoder stage {i}: kernel {k} is not a multiple of "
                f"stride {r} — causal framing cannot carry it; run this "
                f"checkpoint's ONNX graph (io.onnx_exec)")
        mults.append(k // r)
    if len(set(mults)) != 1:
        raise CodecImportError(
            f"non-uniform encoder kernel/stride ratios {mults}; set "
            f"per-stage geometry manually or run the ONNX graph")
    if mults[0] != cfg.stage_kernel_mult:
        cfg = dataclasses.replace(cfg, stage_kernel_mult=mults[0])
    return cfg


def infer_speaker_pooling(initializers: Dict[str, np.ndarray], cfg):
    """Whether a speaker-encoder export pools attentively or with plain
    statistics (x-vector): cfg with that pooling.  An attentive export
    carries the score head's [d, d] matrix.  `attention.*` names decide
    first; else the [d, d] matrices are counted, and where n_mels == d the
    in-projection is one of them, so the head needs a second (the JAX
    importer counts the in-projection as the head there)."""
    import dataclasses
    d = cfg.d_model
    named = any(nm.startswith("attention.") for nm in initializers)
    square = sum(tuple(np.asarray(t).shape) == (d, d)
                 for t in initializers.values())
    need = 2 if cfg.n_mels == d else 1
    pooling = "attentive" if (named or square >= need) else "xvector"
    if pooling != cfg.pooling:
        cfg = dataclasses.replace(cfg, pooling=pooling)
    return cfg


def convert_codec(initializers: Dict[str, np.ndarray], cfg,
                  name_map: Optional[Dict[str, Entry]] = None,
                  init_fn=None, strict_unused: bool = False):
    """The native codec parameter tree (numpy leaves) from ONNX
    initializers, with every failure collected into ONE CodecImportError:
    a source initializer missing from the file, a shape after the
    transform other than the native spec's, non-finite values.
    strict_unused also fails when file tensors go unused (off by default:
    real graphs carry Shape/Constant helper initializers)."""
    from .convert import unflatten
    if init_fn is None:
        from ..models.codec.decoder import init_decoder_params as init_fn
    if name_map is None:
        name_map = decoder_name_map(cfg)
    spec = param_spec(init_fn, cfg)
    errors: List[str] = []
    flat: Dict[str, np.ndarray] = {}
    used: set = set()

    for path in sorted(set(name_map) - set(spec)):
        errors.append(f"name_map entry '{path}' is not a native parameter "
                      f"(valid paths: see param_spec)")

    for path, (shape, dtype) in sorted(spec.items()):
        entry = name_map.get(path)
        if entry is None:
            errors.append(f"missing name_map entry for native param "
                          f"'{path}' {shape}")
            continue
        singles = entry if isinstance(entry, list) else [entry]
        parts = []
        bad = False
        for src, tf in singles:
            if src not in initializers:
                errors.append(f"'{path}': source initializer '{src}' not in "
                              f"file")
                bad = True
                continue
            t = _apply(np.asarray(initializers[src]), tf)
            if not np.isfinite(t).all():
                errors.append(f"'{path}': source '{src}' contains non-finite "
                              f"values")
                bad = True
            parts.append(t)
            used.add(src)
        if bad:
            continue
        arr = np.stack(parts) if isinstance(entry, list) else parts[0]
        if tuple(arr.shape) != tuple(shape):
            errors.append(f"'{path}': shape {tuple(arr.shape)} from "
                          f"{[s for s, _ in singles]} != native {tuple(shape)}")
            continue
        flat[path] = arr.astype(dtype)

    unused = sorted(set(initializers) - used)
    if strict_unused and unused:
        errors.append(f"unused initializers: {unused}")
    if errors:
        raise CodecImportError(
            "codec import failed (%d problems):\n  " % len(errors)
            + "\n  ".join(errors)
            + (f"\nunused initializers ({len(unused)}): {unused[:20]}"
               if unused else ""))
    return unflatten(flat)


def validate_decoder_against_onnx(cfg, params, onnx_decoder,
                                  n_frames: int = 12, seed: int = 0,
                                  rtol: float = 2e-2, atol: float = 2e-2,
                                  ) -> Dict[str, float]:
    """The port's native decoder on `params` (a tree of arrays or
    tensors) and the ONNX graph (an OnnxStreamingDecoder) on the same
    random codes, both on the graph's device: error stats, and
    CodecImportError when more than 0.1 % of the samples are outside
    tolerance.  Settles the transpose conventions that shapes cannot
    (square q/k/v/o matrices); the gate before the native codec path
    runs a real checkpoint."""
    from ..models.codec import decoder as dec
    from ..models.transformer import dtype_of
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, cfg.codebook_size,
                         (1, n_frames, cfg.n_codebooks)).astype(np.int64)
    dtype = dtype_of(cfg.dtype)

    def to_t(tree):
        if isinstance(tree, dict):
            return {k: to_t(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [to_t(v) for v in tree]
        t = torch.as_tensor(np.asarray(tree) if not isinstance(
            tree, torch.Tensor) else tree).to(device)
        return t.to(dtype) if t.is_floating_point() else t

    device = onnx_decoder.device
    with torch.no_grad():
        wav, _ = dec.decode_chunk(cfg, to_t(params),
                                  torch.from_numpy(codes).to(device),
                                  dec.init_decoder_state(cfg, 1, device))
    wav_native = wav[0].float().cpu().numpy()
    wav_onnx, _ = onnx_decoder.decode(codes[0], onnx_decoder.create_state(),
                                      is_final=True)
    wav_onnx = np.asarray(wav_onnx, np.float32)
    n = min(len(wav_native), len(wav_onnx))
    if n == 0:
        raise CodecImportError("validation produced empty waveforms")
    a, b = wav_native[:n], wav_onnx[:n]
    err = np.abs(a - b)
    stats = {
        "max_abs_err": float(err.max()),
        "mean_abs_err": float(err.mean()),
        "rms_native": float(np.sqrt(np.mean(a * a))),
        "rms_onnx": float(np.sqrt(np.mean(b * b))),
        "n_samples": int(n),
    }
    if (err > atol + rtol * np.abs(b)).mean() > 0.001:
        raise CodecImportError(
            f"native decoder does not reproduce the ONNX graph: {stats} — "
            "check the transpose conventions in the name map "
            "(square matrices are shape-ambiguous) and the conv/upsample "
            "geometry in CodecDecoderConfig")
    return stats
