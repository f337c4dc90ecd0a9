"""Seeded weights of one configuration, made by the benchmark on the device.

The port serves its weights in its own parameter layout (stacked per-layer
tensors, [L, in, out] matrices, qkv and gate/up fused along the output
axis), so the benchmark makes them in that layout itself: one normal draw
and one uniform draw per model, on the device's generator, in the dtype the
configuration serves (bf16), carved into views and scaled in place.  The
same seed on the same device gives the same tensors, so the reference can
make them again after the program has gone, and takes nothing the program
made.

Published shapes only: every width comes from the configuration file.
Norm gains, conv biases and snake alphas are drawn too (not left at 1 / 0),
so that a reference that forgets one of them disagrees.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

# seed offsets of the parts, so that no two parts share a stream
PARTS = ("talker", "predictor", "codec", "assets")


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


class _Carver:
    """Views of one flat draw: `take(shape, scale)` returns the next
    prod(shape) values as a tensor of `shape`, scaled in place."""

    def __init__(self, shapes: List[Tuple[Tuple[int, ...], float]],
                 gen: torch.Generator, dtype: torch.dtype, kind: str):
        total = sum(_numel(s) for s, _ in shapes)
        dev = gen.device
        if kind == "normal":
            self.buf = torch.randn(total, generator=gen, dtype=dtype,
                                   device=dev)
        else:
            self.buf = torch.rand(total, generator=gen, dtype=dtype,
                                  device=dev)
        self.at = 0

    def take(self, shape: Tuple[int, ...], scale: float,
             shift: float = 0.0) -> torch.Tensor:
        n = _numel(shape)
        view = self.buf[self.at:self.at + n].view(shape)
        self.at += n
        view.mul_(scale)
        if shift:
            view.add_(shift)
        return view


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _gen(seed: int, part: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 8 + PARTS.index(part)) % (2 ** 63))


def decoder_lm(m: Dict, head_rows: int, seed: int, part: str, device,
               dtype: torch.dtype) -> Dict:
    """A Qwen3 decoder (talker or predictor) in the port's layout, with its
    head [head_rows, d_model]: matrices N(0, 1/fan_in), norm gains in
    [0.8, 1.2)."""
    L, d, f = m["n_layers"], m["d_model"], m["d_ff"]
    h, hkv, dh = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    mats = [((L, d, (h + 2 * hkv) * dh), d ** -0.5),
            ((L, h * dh, d), (h * dh) ** -0.5),
            ((L, d, 2 * f), d ** -0.5),
            ((L, f, d), f ** -0.5),
            ((head_rows, d), d ** -0.5)]
    gains = [((L, d), 0.4), ((L, d), 0.4), ((L, dh), 0.4), ((L, dh), 0.4),
             ((d,), 0.4)]
    g = _gen(seed, part, device)
    nrm = _Carver(mats, g, dtype, "normal")
    uni = _Carver(gains, g, dtype, "uniform")
    wqkv, wo, wgu, wdn, head = (nrm.take(s, c) for s, c in mats)
    ln1, ln2, qn, kn, fn = (uni.take(s, c, 0.8) for s, c in gains)
    return {"layers": {"ln1": ln1, "ln2": ln2, "wqkv": wqkv, "wo": wo,
                       "q_norm": qn, "k_norm": kn, "w_gate_up": wgu,
                       "w_down": wdn},
            "final_norm": fn, "head": head}


def codec_decoder(m: Dict, seed: int, device, dtype: torch.dtype) -> Dict:
    """The native codec decoder in the port's layout (models/codec/decoder)."""
    d, L, h, dh, f = (m["d_model"], m["n_layers"], m["n_heads"],
                      m["head_dim"], m["d_ff"])
    k, chans, ups = m["conv_kernel"], m["channels"], m["upsample_factors"]
    mult = m["upsample_kernel_mult"]
    stage_io = [(chans[i], chans[i + 1] if i + 1 < len(chans) else chans[-1])
                for i in range(len(ups))]
    mats = [((m["n_codebooks"], m["codebook_size"], d), 0.02),
            ((L, d, h * dh), d ** -0.5), ((L, d, h * dh), d ** -0.5),
            ((L, d, h * dh), d ** -0.5), ((L, h * dh, d), (h * dh) ** -0.5),
            ((L, d, f), d ** -0.5), ((L, d, f), d ** -0.5),
            ((L, f, d), f ** -0.5),
            ((chans[0], d, k), (d * k) ** -0.5), ((chans[0],), 0.02)]
    for (ci, co), r in zip(stage_io, ups):
        mats += [((co, ci, r * mult), (ci * r * mult) ** -0.5), ((co,), 0.02),
                 ((co, co, k), (co * k) ** -0.5), ((co,), 0.02),
                 ((co, co, 1), co ** -0.5), ((co,), 0.02)]
    c_last = stage_io[-1][1]
    mats += [((1, c_last, k), (c_last * k) ** -0.5), ((1,), 0.02)]
    gains = [((L, d), 0.4), ((L, d), 0.4), ((d,), 0.4)]
    gains += [((co,), 1.0) for _, co in stage_io for _ in range(2)]
    g = _gen(seed, "codec", device)
    nrm = _Carver(mats, g, dtype, "normal")
    uni = _Carver(gains, g, dtype, "uniform")
    it = iter(nrm.take(s, c) for s, c in mats)
    embed = next(it)
    wq, wk, wv, wo, wg, wu, wd = (next(it) for _ in range(7))
    pre_w, pre_b = next(it), next(it)
    stages = []
    for _ in stage_io:
        up_w, up_b, c1w, c1b, c2w, c2b = (next(it) for _ in range(6))
        stages.append({"up_w": up_w, "up_b": up_b, "conv1_w": c1w,
                       "conv1_b": c1b, "conv2_w": c2w, "conv2_b": c2b})
    out_w, out_b = next(it), next(it)
    ln1, ln2, fn = (uni.take(s, c, 0.8) for s, c in gains[:3])
    for st in stages:                   # snake alphas in [0.5, 1.5)
        st["alpha1"] = uni.take(st["up_b"].shape, 1.0, 0.5)
        st["alpha2"] = uni.take(st["up_b"].shape, 1.0, 0.5)
    return {"embed": embed,
            "layers": {"ln1": ln1, "ln2": ln2, "wq": wq, "wk": wk, "wv": wv,
                       "wo": wo, "w_gate": wg, "w_up": wu, "w_down": wd},
            "final_norm": fn,
            "pre_conv": {"w": pre_w, "b": pre_b},
            "stages": stages,
            "out_conv": {"w": out_w, "b": out_b}}


def assets(m: Dict, seed: int, device, dtype: torch.dtype) -> Dict:
    """The embedding tables and the 2048 -> 1024 projection, as a model
    directory's assets hold them: text [text_rows, 2048], codec
    [16, codec_rows, 2048] (both in `dtype`), proj_w [1024, 2048] and
    proj_b [1024] (f32)."""
    d = m["talker_dim"]
    mats = [((m["text_rows"], d), 0.02),
            ((m["n_codebooks"], m["codec_rows"], d), 0.02)]
    g = _gen(seed, "assets", device)
    nrm = _Carver(mats, g, dtype, "normal")
    text, codec = (nrm.take(s, c) for s, c in mats)
    proj = _Carver([((m["predictor_dim"], d), 0.02),
                    ((m["predictor_dim"],), 0.02)], g, torch.float32,
                   "normal")
    proj_w = proj.take((m["predictor_dim"], d), 0.02)
    proj_b = proj.take((m["predictor_dim"],), 0.02)
    return {"text": text, "codec": codec, "proj_w": proj_w, "proj_b": proj_b}


def make(config: Dict, seed: int, device) -> Dict:
    """Every part of `config["model"]` from `seed` on `device`:
    {"talker", "predictor" (decoder_lm dicts, the head under "head"),
    "codec", "assets"}."""
    m = config["model"]
    dt = _dtype(m["dtype"])
    t, p = m["talker"], m["predictor"]
    with torch.no_grad():
        return {
            "talker": decoder_lm(t, t["n_codec_logits"], seed, "talker",
                                 device, dt),
            "predictor": decoder_lm(
                p, p["n_residual_codebooks"] * p["codebook_size"], seed,
                "predictor", device, dt),
            "codec": codec_decoder(m["codec_decoder"], seed, device, dt),
            "assets": assets(m["assets"], seed, device, dt),
        }
