"""Turn the JAX package's parameter trees into the port's tensors.

The inputs are nested dicts (and tuples/lists) of numpy arrays, e.g.
`jax.tree_util.tree_map(np.asarray, params)`; this module itself never
imports jax.  Layouts are the same in both packages, so the conversion is
one tensor per array, dtype kept (bfloat16 numpy arrays go through f32,
which is exact).  Tests use it to run both packages on the same weights.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..ops.quant import pack_int4
from .assets import Assets


def to_tensor(a, device="cpu") -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device,
                                                          torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)    # copy: writable


def tree_to_torch(tree, device="cpu"):
    """Nested dict / tuple / list of arrays -> same nesting of tensors
    (tuples become lists)."""
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [tree_to_torch(v, device) for v in tree]
    return to_tensor(tree, device)


def assets_from_arrays(a: Dict[str, Any], device="cpu") -> Assets:
    """Assets from the JAX Assets' arrays: a dict with text_table,
    codec_tables, codec_tables_1024, proj_w, proj_b, tts_pad (taken as
    they are, not recomputed)."""
    t = {k: to_tensor(a[k], device)
         for k in ("text_table", "codec_tables", "codec_tables_1024",
                   "proj_w", "proj_b", "tts_pad")}
    return Assets(text_rows=int(t["text_table"].shape[0]),
                  codec_rows=int(t["codec_tables"].shape[1]), **t)


def engine_weights(assets: Dict[str, Any], talker, predictor, codec_decoder,
                   device="cpu", codec_encoder=None,
                   speaker_encoder=None) -> Dict[str, Any]:
    """The `weights` argument of TtsEngine from the JAX package's arrays;
    the cloning encoders (encoder_from_jax, speaker_from_jax) when given."""
    out = {"assets": assets_from_arrays(assets, device),
           "talker": tree_to_torch(talker, device),
           "predictor": tree_to_torch(predictor, device),
           "codec_decoder": tree_to_torch(codec_decoder, device)}
    if codec_encoder is not None:
        out["codec_encoder"] = encoder_from_jax(codec_encoder, device)
    if speaker_encoder is not None:
        out["speaker_encoder"] = speaker_from_jax(speaker_encoder, device)
    return out


def encoder_from_jax(params, device="cpu") -> Dict[str, Any]:
    """models/codec/encoder's params from the JAX engine's
    `codec_encoder_params`: in_conv {w, b}, the tuple of stages {w, b}
    (a list here), out_proj, codebooks; layouts kept."""
    p = tree_to_torch(params, device)
    if set(p) != {"in_conv", "stages", "out_proj", "codebooks"}:
        raise ValueError(f"not a codec encoder tree: {sorted(p)}")
    return p


def speaker_from_jax(params, device="cpu") -> Dict[str, Any]:
    """models/codec/speaker's params from the JAX engine's
    `speaker_params`: in_proj, the tuple of convs {w, b} (a list here),
    head and, for attentive pooling, attn_w and attn_v; layouts kept."""
    p = tree_to_torch(params, device)
    if not {"in_proj", "convs", "head"} <= set(p):
        raise ValueError(f"not a speaker encoder tree: {sorted(p)}")
    return p


def draft_from_jax(params, device="cpu") -> Dict[str, torch.Tensor]:
    """runtime/spec's draft head from the JAX `init_draft_params` tree (or
    a trained head in its layout): trunk [2D, Dh], trunk_b [Dh], head0
    [Dh, 2160], heads [15, Dh, 2048]; layouts and dtypes kept."""
    p = tree_to_torch(params, device)
    if set(p) != {"trunk", "trunk_b", "head0", "heads"}:
        raise ValueError(f"not a draft head tree: {sorted(p)}")
    return p


def talker_w4a8_from_jax(layer_w: Dict[str, Any], device="cpu"
                         ) -> Dict[str, torch.Tensor]:
    """The port's kernels/talker_step weights from the JAX package's
    `prep_layer_weights(cfg, params, "w4a8")` arrays: the half-split int4
    bytes ([L, K/2, N], byte row r = K-row r in the low nibble, K-row
    r + K/2 in the high one) are unpacked and packed again in the port's
    layout (ops.quant.pack_int4), the bf16 scales [L, K/128, N] are
    transposed to [L, N, K/128], the tiled per-head norms are cut to one
    head and the segment matrices dropped."""
    dh = np.asarray(layer_w["seg_q"]).shape[0] // np.asarray(
        layer_w["seg_q"]).shape[1]
    out = {"ln1": to_tensor(layer_w["ln1"], device).float(),
           "ln2": to_tensor(layer_w["ln2"], device).float(),
           "qn": to_tensor(np.asarray(layer_w["qn"])[:, :dh], device).float(),
           "kn": to_tensor(np.asarray(layer_w["kn"])[:, :dh], device).float()}
    for name in ("wqkv", "wo", "gu", "dn"):
        u = np.asarray(layer_w[name + "_q"]).astype(np.uint8).astype(np.int16)
        lo, hi = u & 0xF, (u >> 4) & 0xF
        q = np.concatenate([lo, hi], axis=-2)          # [L, K, N], K order
        q = np.where(q >= 8, q - 16, q).astype(np.int8)
        out[name + "_q"] = pack_int4(torch.from_numpy(q)).to(device)
        out[name + "_s"] = to_tensor(layer_w[name + "_s"], device).transpose(
            -1, -2).contiguous().to(torch.bfloat16)
    return out


def int4_from_jax(w4: Dict[str, Any], device="cpu") -> Dict[str, torch.Tensor]:
    """The port's int4 dict (ops.quant: {"q4": uint8 [..., N, K/2]
    output-major, "s": f32 [..., N, K/G]}) from the JAX package's
    `quantize_weight_int4` dict: interleaved q4 int8 [..., K/2, N], byte i
    = K-row 2i in the low nibble and 2i + 1 in the high one, both
    sign-extended; s f32 [..., K/G, N]."""
    u = np.asarray(w4["q4"]).astype(np.uint8).astype(np.int16)
    lo, hi = u & 0xF, (u >> 4) & 0xF
    q = np.stack([lo, hi], axis=-2)                     # [..., K/2, 2, N]
    q = q.reshape(*u.shape[:-2], 2 * u.shape[-2], u.shape[-1])
    q = np.where(q >= 8, q - 16, q).astype(np.int8)
    s = np.asarray(w4["s"], np.float32)
    return {"q4": pack_int4(torch.from_numpy(q)).to(device),
            "s": torch.from_numpy(np.ascontiguousarray(
                np.swapaxes(s, -1, -2))).to(device)}


def _int4_from_half_split(a) -> torch.Tensor:
    """The JAX half-split int4 bytes [L, K/2, N] (byte row r = K-row r in
    the low nibble, K-row r + K/2 in the high one) as int8 values
    [L, K, N]."""
    u = np.asarray(a).astype(np.uint8).astype(np.int16)
    q = np.concatenate([u & 0xF, (u >> 4) & 0xF], axis=-2)
    return torch.from_numpy(np.where(q >= 8, q - 16, q).astype(np.int8))


def chunk_pack_from_jax(pred_w: Dict[str, Any], extras: Dict[str, Any],
                        device="cpu") -> Dict[str, Dict[str, torch.Tensor]]:
    """The port's kernels/chunk_step pack {"pred_w", "extras"} from the JAX
    package's `prep_predictor_w4` and `prep_chunk_extras` arrays.

    pred_w: the q columns of wqkv go back from the JAX kernel's c-major
    head order (`_head_perm`) to head order; wo keeps its row order, which
    is the port's too (kernels/chunk_step docstring); the half-split int4
    bytes are packed again in ops.quant.pack_int4's layout and the f32
    scales [L, K/128, N] transposed to [L, N, K/128]; norms lose their
    tiling and middle axis.  extras: the codec head loses its padding rows
    [2160, 2176), proj_w is transposed back to [1024, 2048], the row
    vectors lose their leading axis and the rope rows their tiling."""
    seg = np.asarray(pred_w["seg_q"])
    h, dh = seg.shape[1], seg.shape[0] // seg.shape[1]
    hkv = np.asarray(pred_w["seg_k"]).shape[1]
    dq = h * dh
    rep = h // hkv
    perm = np.concatenate([np.arange(dh) + ((i % hkv) * rep + i // hkv) * dh
                           for i in range(h)])

    def unperm_cols(a):
        a = np.array(a)
        a[..., perm] = np.array(a[..., :dq])
        return a

    pw = {"ln1": to_tensor(np.asarray(pred_w["ln1"])[:, 0], device).float(),
          "ln2": to_tensor(np.asarray(pred_w["ln2"])[:, 0], device).float(),
          "qn": to_tensor(np.asarray(pred_w["qn"])[:, 0, :dh],
                          device).float(),
          "kn": to_tensor(np.asarray(pred_w["kn"])[:, 0, :dh],
                          device).float()}
    for name in ("wqkv", "wo", "gu", "dn"):
        q = _int4_from_half_split(pred_w[name + "_q"])
        s = np.asarray(pred_w[name + "_s"], np.float32)
        if name == "wqkv":
            q = torch.from_numpy(unperm_cols(q.numpy()))
            s = unperm_cols(s)
        pw[name + "_q"] = pack_int4(q).to(device)
        pw[name + "_s"] = torch.from_numpy(
            np.ascontiguousarray(s.transpose(0, 2, 1))).to(device)
    e = {k: np.asarray(v) for k, v in extras.items()}
    v_codec = 2160
    pdh = e["pcos"].shape[1] // h
    ex = {"tfn": e["tfn"][0], "chead_q": e["chead_q"][:v_codec],
          "chead_s": e["chead_s"][0, :v_codec], "proj_w": e["proj_w"].T,
          "proj_b": e["proj_b"][0], "tts_pad": e["tts_pad"][0],
          "pfn": e["pfn"][0], "phead_q": e["phead_q"],
          "phead_s": e["phead_s"].reshape(-1), "pcos": e["pcos"][:, :pdh],
          "psin": e["psin"][:, :pdh], "ctab_fb": e["ctab_fb"],
          "ctab_pred": e["ctab_pred"]}
    ex = {k: to_tensor(np.ascontiguousarray(v), device)
          for k, v in ex.items()}
    for k in ("tfn", "chead_s", "proj_w", "proj_b", "tts_pad", "pfn",
              "phead_s", "pcos", "psin"):
        ex[k] = ex[k].float()
    return {"pred_w": pw, "extras": ex}
