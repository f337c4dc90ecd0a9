"""GGUF checkpoint import for the talker and predictor LMs.  Port of
qwen3_tts_tpu/io/weights.py.

The GGUF files are parsed with io.gguf (a numpy copy of the JAX package's
reader), dequantized to f32 numpy one tensor at a time, and written onto
the device into the stacked-layer parameter dicts of models.transformer,
in the config's dtype: the llama.cpp tensor names (`blk.<i>.attn_q`, ...),
q/k/v fused along the output axis into `wqkv` and gate/up into
`w_gate_up`, every matrix transposed to [in, out].  The host never holds
more than one tensor, so a 2.8 GB talker file loads with a few hundred MB
of host memory.  Model dims come from the GGUF metadata
(`config_from_gguf`); the talker's LM head is cut to its codec slice
[0, n_codec_logits).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence, Tuple

import torch

from ..core.config import PredictorConfig, TalkerConfig
from ..models.transformer import dtype_of
from .gguf import GGUFFile, read_gguf


def _meta(g: GGUFFile, arch: str, key: str, default=None):
    return g.metadata.get(f"{arch}.{key}", default)


def config_from_gguf(g: GGUFFile, base) -> Any:
    """Derive a TalkerConfig/PredictorConfig from GGUF metadata, keeping
    `base` fields where metadata is absent."""
    arch = g.metadata.get("general.architecture", "qwen3")
    n_layers = _meta(g, arch, "block_count", base.n_layers)
    n_heads = _meta(g, arch, "attention.head_count", base.n_heads)
    n_kv = _meta(g, arch, "attention.head_count_kv", base.n_kv_heads)
    d_model = _meta(g, arch, "embedding_length", base.d_model)
    d_ff = _meta(g, arch, "feed_forward_length", base.d_ff)
    head_dim = _meta(g, arch, "attention.key_length",
                     d_model // max(int(n_heads), 1))
    theta = _meta(g, arch, "rope.freq_base", base.rope_theta)
    eps = _meta(g, arch, "attention.layer_norm_rms_epsilon", base.rms_eps)
    upd = dict(n_layers=int(n_layers), n_heads=int(n_heads),
               n_kv_heads=int(n_kv), d_model=int(d_model), d_ff=int(d_ff),
               head_dim=int(head_dim), rope_theta=float(theta),
               rms_eps=float(eps))
    if isinstance(base, TalkerConfig):
        sections = (_meta(g, arch, "rope.mrope_section")
                    or _meta(g, arch, "rope.dimension_sections"))
        if sections:
            sections = tuple(int(s) for s in sections)
            while len(sections) < 4:
                sections = sections + (0,)
            upd["mrope_sections"] = sections
    return dataclasses.replace(base, **upd)


def _tensor(g: GGUFFile, name: str, device) -> torch.Tensor:
    """One GGUF tensor, dequantized to f32, on `device`."""
    return torch.from_numpy(g.read_tensor(name)).to(device)


def _stack_layers(g: GGUFFile, cfg, dtype, device) -> Dict[str, Any]:
    n_layers = cfg.n_layers

    def stack(suffix: str, transpose: bool) -> torch.Tensor:
        out = None
        for i in range(n_layers):
            t = _tensor(g, f"blk.{i}.{suffix}", device)
            t = t.t() if transpose else t
            if out is None:
                out = torch.empty((n_layers, *t.shape), dtype=dtype,
                                  device=device)
            out[i] = t
        return out

    def stack_fused(suffixes: Sequence[str]) -> torch.Tensor:
        # fused along the output-feature axis (see models.transformer)
        out = None
        for i in range(n_layers):
            parts = [_tensor(g, f"blk.{i}.{sfx}.weight", device).t()
                     for sfx in suffixes]
            if out is None:
                n_out = sum(p.shape[1] for p in parts)
                out = torch.empty((n_layers, parts[0].shape[0], n_out),
                                  dtype=dtype, device=device)
            c0 = 0
            for p in parts:
                out[i, :, c0:c0 + p.shape[1]] = p
                c0 += p.shape[1]
        return out

    layers = {
        "ln1": stack("attn_norm.weight", False),
        "ln2": stack("ffn_norm.weight", False),
        "wqkv": stack_fused(("attn_q", "attn_k", "attn_v")),
        "wo": stack("attn_output.weight", True),
        "w_gate_up": stack_fused(("ffn_gate", "ffn_up")),
        "w_down": stack("ffn_down.weight", True),
    }
    if "blk.0.attn_q_norm.weight" in g.tensors:
        layers["q_norm"] = stack("attn_q_norm.weight", False)
        layers["k_norm"] = stack("attn_k_norm.weight", False)
    else:
        layers["q_norm"] = torch.ones(n_layers, cfg.head_dim, dtype=dtype,
                                      device=device)
        layers["k_norm"] = torch.ones(n_layers, cfg.head_dim, dtype=dtype,
                                      device=device)
    return layers


def _output_weight(g: GGUFFile, device, rows=None) -> torch.Tensor:
    name = ("output.weight" if "output.weight" in g.tensors
            else "token_embd.weight")
    return _tensor(g, name, device)[:rows]


def load_talker_gguf(path, base: TalkerConfig, device="cpu",
                     ) -> Tuple[TalkerConfig, Dict[str, Any]]:
    g = read_gguf(path)
    cfg = config_from_gguf(g, base)
    dtype = dtype_of(cfg.dtype)
    params = {
        "layers": _stack_layers(g, cfg, dtype, device),
        "final_norm": _tensor(g, "output_norm.weight", device).to(dtype),
        # only the codec slice [0, n_codec_logits) of the LM head is
        # sampled (the reference's engine.rs:555)
        "codec_head": _output_weight(g, device, cfg.n_codec_logits).to(
            dtype).contiguous(),
    }
    return cfg, params


def load_predictor_gguf(path, base: PredictorConfig, device="cpu",
                        ) -> Tuple[PredictorConfig, Dict[str, Any]]:
    g = read_gguf(path)
    cfg = config_from_gguf(g, base)
    dtype = dtype_of(cfg.dtype)
    params = {
        "layers": _stack_layers(g, cfg, dtype, device),
        "final_norm": _tensor(g, "output_norm.weight", device).to(dtype),
        "lm_head": _output_weight(g, device).to(dtype),
    }
    return cfg, params
