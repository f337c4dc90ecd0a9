"""Operations and bytes of the decode, from a configuration's shapes and
served formats: the least work a call needs, so that a time bound from
them can never exceed the time the card took.

Bytes count each input read once and each output written once per call;
KV rows at the lanes' real cursors (active lanes only); operations are
the multiply-adds (x2) of the matrices and the attention.  A frame step
(`frame_step`, for the whole-step share of the peak) counts the talker,
predictor, heads and projection weights once per step less the card's L2
(which could hold that much from the step before), plus each active
lane's KV.  Formats as in reference/quant.py.

The card's published peaks (NVIDIA H100 SXM data sheet, dense, at its 700
W limit): 3.35 TB/s of HBM3, 1,979 TOP/s int8, 989 TFLOP/s bf16, 67
TFLOP/s f32; 50 MB of L2.  A time bound takes the operations at the
highest of the peaks (int8), which no kind of operation beats.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 1979e12
L2_BYTES = 50e6
GROUP = 128


def matrix_bytes(k: int, n: int, fmt: str) -> float:
    if fmt == "plain":
        return 2.0 * k * n
    if fmt.startswith("int8_col"):
        return k * n + 4.0 * n
    if fmt == "w4a8_bf16s":
        return k * n / 2 + 2.0 * n * k / GROUP
    if fmt.startswith("w4a8_f32s"):
        return k * n / 2 + 4.0 * n * k / GROUP
    raise ValueError(f"unknown format {fmt!r}")


def head_bytes(v: int, d: int, fmt: str) -> float:
    if fmt == "plain":
        return 2.0 * v * d
    if fmt == "int8_row":
        return v * d + 4.0 * v
    raise ValueError(f"unknown head format {fmt!r}")


def _mats(m: Dict):
    d, f = m["d_model"], m["d_ff"]
    h, hkv, dh = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    return [(d, (h + 2 * hkv) * dh), (h * dh, d), (d, 2 * f), (f, d)]


def layer_params(m: Dict) -> int:
    return m["n_layers"] * sum(k * n for k, n in _mats(m))


def layer_bytes(m: Dict, fmt: str) -> float:
    return m["n_layers"] * sum(matrix_bytes(k, n, fmt) for k, n in _mats(m))


def kv_row_bytes(m: Dict) -> float:
    """k and v of one token over all layers, bf16."""
    return m["n_layers"] * 2 * m["n_kv_heads"] * m["head_dim"] * 2.0


def attn_ops(m: Dict, tokens: int) -> float:
    return 4.0 * m["n_layers"] * m["n_heads"] * m["head_dim"] * tokens


def talker_step(model: Dict, fmt: Dict, cursors: Iterable[int]
                ) -> Tuple[float, float]:
    """(ops, bytes) of one talker decode step over the lanes at `cursors`
    (their KV lengths before the step)."""
    t = model["talker"]
    cursors = list(cursors)
    ops = sum(2.0 * layer_params(t) + attn_ops(t, c + 1) for c in cursors)
    by = layer_bytes(t, fmt["talker_decode"])
    by += sum(kv_row_bytes(t) * (c + 1) + 4.0 * t["d_model"]
              for c in cursors)
    return ops, by


def predictor_frame(model: Dict, fmt: Dict, lanes: int
                    ) -> Tuple[float, float]:
    """(ops, bytes) of the predictor's 15 codes of one frame on `lanes`."""
    p = model["predictor"]
    n_cb, size = p["n_residual_codebooks"], p["codebook_size"]
    tokens = n_cb + 1
    ops = lanes * (tokens * 2.0 * layer_params(p)
                   + sum(attn_ops(p, j + 1) for j in range(tokens))
                   + n_cb * 2.0 * size * p["d_model"])
    by = (layer_bytes(p, fmt["predictor"])
          + head_bytes(n_cb * size, p["d_model"], fmt["predictor_head"])
          + lanes * (4.0 * p["d_model"] + 4.0 * tokens))
    return ops, by


def _fixed_frame(model: Dict, fmt: Dict) -> Tuple[float, float]:
    """Per frame and lane: the ops of the heads and projection; the bytes
    of all weights read once."""
    t, p = model["talker"], model["predictor"]
    v = t["n_codec_logits"]
    pd = p["d_model"]
    ops = 2.0 * v * t["d_model"] + 2.0 * pd * t["d_model"]
    by = (layer_bytes(t, fmt["talker_decode"])
          + layer_bytes(p, fmt["predictor"])
          + head_bytes(v, t["d_model"], fmt["codec_head"])
          + head_bytes(p["n_residual_codebooks"] * p["codebook_size"], pd,
                       fmt["predictor_head"])
          + 4.0 * pd * t["d_model"])
    return ops, by


def chunk_call(model: Dict, fmt: Dict, n_frames: int, cursor: int
               ) -> Tuple[float, float]:
    """(ops, bytes) of one launch of the chunk kernel: n_frames frames of
    one lane whose KV holds `cursor` rows at its start; every weight read
    once for the call."""
    t = model["talker"]
    ops_t = 0.0
    for i in range(n_frames):
        ops_t += talker_step(model, fmt, [cursor + i])[0]
    ops_p, _ = predictor_frame(model, fmt, 1)
    ops_f, by_w = _fixed_frame(model, fmt)
    ops = ops_t + n_frames * (ops_p + ops_f)
    by = by_w + kv_row_bytes(t) * (cursor + n_frames)
    return ops, by


def frame_step(model: Dict, fmt: Dict, cursors: Iterable[int]
               ) -> Tuple[float, float]:
    """(ops, bytes) of one whole frame step (sample, project, predictor,
    feedback, talker step, head) of the lanes at `cursors`: the weights
    once less L2, each lane's KV."""
    t = model["talker"]
    cursors = list(cursors)
    ops_p, _ = predictor_frame(model, fmt, len(cursors))
    ops_f, by_w = _fixed_frame(model, fmt)
    ops = (talker_step(model, fmt, cursors)[0] + ops_p
           + ops_f * len(cursors))
    by = max(0.0, by_w - L2_BYTES) + sum(kv_row_bytes(t) * (c + 1)
                                         for c in cursors)
    return ops, by


def seconds(ops: float, by: float) -> float:
    """The least time of (ops, bytes) on the card."""
    return max(ops / PEAK_OPS_PER_S, by / HBM_BYTES_PER_S)
