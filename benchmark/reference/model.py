"""Plain float32 reference of the Qwen3-TTS decode: talker, code predictor,
heads and feedback, teacher-forced on the codes a run served.

A Qwen3 decoder: pre-RMSNorm, grouped-query attention with per-head q/k
RMSNorm and rotary positions (NeoX halves; the talker's M-RoPE with equal
temporal, height and width positions and no channel section is plain
RoPE), SwiGLU, a final RMSNorm.  Everything in f32 with TF32 off; the
weights take the served formats of reference/quant.py.  `low` is applied
to every activation a matmul reads, to k and v and to the residual stream:
the identity for the reference, fp8 rounding for the control.

Per request of prompt P ([S, 2048]) and served codes C ([F, 16]):
- talker over P (the prefill weights) then over the feedback rows of
  frames 0 .. F-2 (the decode weights), causal, positions 0 .. S+F-2; the
  hidden at row S-1+t gives frame t's code-0 logits (the prefill head for
  t = 0, the decode head after) and the predictor's input;
- predictor per frame: tokens [proj(hidden), emb1024_0(code_0),
  emb1024_1(code_1), ... emb1024_14(code_14)] at positions 0..15, causal;
  token j (1..15) gives the logits of codebook j over lm-head rows
  [(j-1) * 2048, j * 2048).  emb1024 = codec tables projected to 1024.

Nothing here imports the program.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from . import quant

Low = Callable[[torch.Tensor], torch.Tensor]


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [S, H, Dh] at integer positions pos [S]."""
    dh = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float64,
                                       device=x.device) / dh)
    ang = pos.double()[:, None] * inv[None, :]
    cos = torch.cat([ang.cos(), ang.cos()], -1).float()[:, None, :]
    sin = torch.cat([ang.sin(), ang.sin()], -1).float()[:, None, :]
    half = dh // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], -1)
    return x * cos + rot * sin


class Layers:
    """One decoder's layers in one served format, as f32 values, made once
    (dequantized layer by layer when first used)."""

    def __init__(self, raw: Dict, m: Dict, fmt: str):
        self.raw, self.m, self.fmt = raw, m, fmt
        self.act = quant.activation_rule(fmt)
        self._cache: Dict[Tuple[str, int], torch.Tensor] = {}

    def w(self, name: str, layer: int) -> torch.Tensor:
        key = (name, layer)
        if key not in self._cache:
            heads = ((self.m["n_heads"], self.m["n_kv_heads"],
                      self.m["head_dim"]) if name == "wo" else None)
            self._cache[key] = quant.weight(self.raw["layers"][name][layer],
                                            self.fmt, heads)
        return self._cache[key]

    def mm(self, x: torch.Tensor, name: str, layer: int,
           low: Low) -> torch.Tensor:
        return self.act(low(x)) @ self.w(name, layer)


def decoder(m: Dict, parts, x: torch.Tensor, pos: torch.Tensor,
            low: Low) -> torch.Tensor:
    """Causal decoder over rows x [B, S, D] at positions pos [S]; parts: a
    list of (Layers, row_start, row_end) giving the weights of each range of
    rows.  Returns the final-normed hidden [B, S, D] (before `low`)."""
    h, hkv, dh, eps = m["n_heads"], m["n_kv_heads"], m["head_dim"], \
        m["rms_eps"]
    b, s = x.shape[0], x.shape[1]
    raw = parts[0][0].raw["layers"]
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    x = low(x.float())
    for layer in range(m["n_layers"]):
        def proj(inp, name):
            return torch.cat([lay.mm(inp[:, a:e], name, layer, low)
                              for lay, a, e in parts], 1)

        hn = rms(x, raw["ln1"][layer], eps)
        qkv = proj(hn, "wqkv")
        q = qkv[..., :h * dh].reshape(b, s, h, dh)
        k = qkv[..., h * dh:(h + hkv) * dh].reshape(b, s, hkv, dh)
        v = qkv[..., (h + hkv) * dh:].reshape(b, s, hkv, dh)
        q = rms(q, raw["q_norm"][layer], eps)
        k = rms(k, raw["k_norm"][layer], eps)
        q = rope(q, pos, m["rope_theta"])
        k = low(rope(k, pos, m["rope_theta"]))
        v = low(v)
        rep = h // hkv
        kk = k.repeat_interleave(rep, dim=2)
        vv = v.repeat_interleave(rep, dim=2)
        sc = torch.einsum("bshd,bthd->bhst", low(q), kk) * dh ** -0.5
        sc = sc.masked_fill(~causal, float("-inf"))
        ctx = torch.einsum("bhst,bthd->bshd", torch.softmax(sc, -1), vv)
        x = low(x + proj(ctx.reshape(b, s, h * dh), "wo"))
        hn = rms(x, raw["ln2"][layer], eps)
        gu = proj(hn, "w_gate_up")
        f = gu.shape[-1] // 2
        x = low(x + proj(F.silu(gu[..., :f]) * gu[..., f:], "w_down"))
    return rms(x, parts[0][0].raw["final_norm"], eps)


class Reference:
    """The reference of one configuration and batch path: its served
    formats (`fmt`, a dict of the configuration file's "formats") over the
    benchmark's raw weights (harness/weights.make)."""

    def __init__(self, model: Dict, raw: Dict, fmt: Dict, low: Low,
                 share: "Reference" = None):
        """share: a Reference of the same weights and formats whose f32
        weight values this one reuses (the control beside the reference)."""
        self.m, self.raw, self.fmt, self.low = model, raw, fmt, low
        if share is not None:
            for name in ("t_prefill", "t_decode", "pred", "head_first",
                         "head_rest", "p_head"):
                setattr(self, name, getattr(share, name))
        else:
            t, p = raw["talker"], raw["predictor"]
            self.t_prefill = Layers(t, model["talker"],
                                    fmt["talker_prefill"])
            self.t_decode = Layers(t, model["talker"], fmt["talker_decode"])
            self.pred = Layers(p, model["predictor"], fmt["predictor"])
            self.head_first = quant.head(t["head"], fmt["codec_head_first"])
            self.head_rest = quant.head(t["head"], fmt["codec_head"])
            self.p_head = quant.head(p["head"], fmt["predictor_head"])
        a = raw["assets"]
        self.codec_tables = a["codec"]
        self.proj_w, self.proj_b = a["proj_w"].float(), a["proj_b"].float()
        self.tables_1024 = (torch.einsum("qrd,od->qro", a["codec"].float(),
                                         self.proj_w) + self.proj_b)
        # the marker row; a table too short to hold it (the tests' tiny
        # tables) has none
        self.tts_pad = (a["text"][151671].float() if a["text"].shape[0] > 151671
                        else torch.zeros_like(a["text"][0], dtype=torch.float32))

    def talker_logits(self, prompt: torch.Tensor, fb: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """prompt [S, 2048], feedback rows fb [F-1, 2048] -> (code-0 logits
        [F, V], hidden [F, 2048]) of frames 0 .. F-1."""
        mt = self.m["talker"]
        s, f1 = prompt.shape[0], fb.shape[0]
        x = torch.cat([prompt.float(), fb.float()], 0)
        pos = torch.arange(s + f1, device=x.device)
        hid = decoder(mt, [(self.t_prefill, 0, s),
                           (self.t_decode, s, s + f1)], x[None], pos,
                      self.low)[0]
        hid = self.low(hid[s - 1:])
        logits = torch.cat([hid[:1] @ self.head_first.t(),
                            hid[1:] @ self.head_rest.t()], 0)
        return logits, hid

    def predictor_logits(self, hidden: torch.Tensor, codes: torch.Tensor,
                         frames_per_block: int = 256) -> torch.Tensor:
        """hidden [F, 2048], served codes [F, 16] -> logits [F, 15, 2048] of
        codebooks 1..15 (each over its own head window)."""
        mp = self.m["predictor"]
        n_cb, size = mp["n_residual_codebooks"], mp["codebook_size"]
        out = []
        for a in range(0, hidden.shape[0], frames_per_block):
            h = hidden[a:a + frames_per_block]
            c = codes[a:a + frames_per_block].long().clamp(
                0, self.tables_1024.shape[1] - 1)
            x0 = h @ self.proj_w.t() + self.proj_b
            embs = [self.tables_1024[q][c[:, q]] for q in range(n_cb)]
            x = torch.stack([x0] + embs, 1)                 # [fr, 16, 1024]
            pos = torch.arange(n_cb + 1, device=x.device)
            hid = decoder(mp, [(self.pred, 0, n_cb + 1)], x, pos, self.low)
            hid = self.low(hid[:, 1:])                      # [fr, 15, 1024]
            w = self.p_head.reshape(n_cb, size, -1)
            out.append(torch.einsum("fjd,jvd->fjv", hid, w))
        return torch.cat(out, 0)
