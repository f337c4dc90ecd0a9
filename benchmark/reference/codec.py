"""Plain float32 reference of the native 12 Hz codec decoder: codes
[F, 16] -> 24 kHz waveform [F * 2000], decoded whole from a fresh state.

The sum of the 16 codebook embeddings; n_layers pre-RMSNorm transformer
layers with RoPE (theta rope_theta) over the frames, each frame attending
the last attn_window frames up to itself; a final RMSNorm; a causal conv
(kernel conv_kernel, zero history) to channels[0]; per upsampling stage a
conv-transpose with kernel = stride (upsample_kernel_mult 1), then the
residual branch snake -> causal conv -> snake -> 1x1 conv added back;
a causal output conv to one channel; tanh.  snake(x) = x + sin(a x)^2 / a.
`low` as in reference/model.py.  Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .model import Low, rms, rope


def _causal(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    k = w.shape[-1]
    return F.conv1d(F.pad(x, (k - 1, 0)), w.float(), b.float())


def _snake(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    a = a.float()[None, :, None]
    return x + torch.sin(a * x) ** 2 / (a + 1e-9)


def decode(m: Dict, p: Dict, codes: torch.Tensor, low: Low) -> torch.Tensor:
    if m["upsample_kernel_mult"] != 1:
        raise ValueError("the reference decodes kernel == stride upsampling")
    n = codes.shape[0]
    size = m["codebook_size"]
    c = codes.long().clamp(0, size - 1)
    x = sum(p["embed"][q][c[:, q]].float() for q in range(m["n_codebooks"]))
    x = low(x)
    h, dh, eps, win = m["n_heads"], m["head_dim"], m["rms_eps"], \
        m["attn_window"]
    pos = torch.arange(n, device=x.device)
    keep = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - win)
    lay = p["layers"]
    for i in range(m["n_layers"]):
        hn = low(rms(x, lay["ln1"][i], eps))
        q = (hn @ lay["wq"][i].float()).reshape(n, h, dh)
        k = (hn @ lay["wk"][i].float()).reshape(n, h, dh)
        v = low((hn @ lay["wv"][i].float()).reshape(n, h, dh))
        q = low(rope(q, pos, m["rope_theta"]))
        k = low(rope(k, pos, m["rope_theta"]))
        sc = torch.einsum("shd,thd->hst", q, k) * dh ** -0.5
        sc = sc.masked_fill(~keep[None], float("-inf"))
        ctx = low(torch.einsum("hst,thd->shd", torch.softmax(sc, -1), v))
        x = low(x + ctx.reshape(n, h * dh) @ lay["wo"][i].float())
        hn = low(rms(x, lay["ln2"][i], eps))
        ff = low(F.silu(hn @ lay["w_gate"][i].float())
                 * (hn @ lay["w_up"][i].float()))
        x = low(x + ff @ lay["w_down"][i].float())
    y = low(rms(x, p["final_norm"], eps)).t()[None]        # [1, d, n]
    y = low(_causal(y, p["pre_conv"]["w"], p["pre_conv"]["b"]))
    for st, r in zip(p["stages"], m["upsample_factors"]):
        w = st["up_w"].float()                              # [co, ci, r]
        y = torch.einsum("bct,ocr->botr", y, w).reshape(1, w.shape[0], -1)
        y = low(y + st["up_b"].float()[None, :, None])
        res = y
        z = low(_snake(y, st["alpha1"]))
        z = low(_causal(z, st["conv1_w"], st["conv1_b"]))
        z = low(_snake(z, st["alpha2"]))
        z = _causal(z, st["conv2_w"], st["conv2_b"])
        y = low(res + z)
    y = _causal(y, p["out_conv"]["w"], p["out_conv"]["b"])
    return torch.tanh(y[0, 0])
