"""`correct`: the served requests against the plain reference.

Once the window has closed and the program is gone, a sample of the
requests it finished (the longest, and `sample - 1` more drawn from the
seed) is run through reference/ teacher-forced on the codes it served:

- gap_code0: the widest gap by which a served code 0 lies below the
  reference's k-th best code-0 logit at its frame (k = 1 for a greedy
  request, the sampler's top_k for a sampled one: a sampled code has to be
  one the reference would keep);
- gap_residual: the widest gap by which a served code of codebooks 1..15
  (the predictor's greedy argmaxes) lies below the reference's best logit
  of its window;
- audio_err: the largest absolute difference between the served audio and
  the reference codec's decode of the served codes (a served waveform of
  the wrong length reads inf).

The control (`control=True`) is the reference in the program's place with
fp8 activations: at each position of the same prompts and codes, the gap
of the code the control ranks k-th (first) in the f32 reference, and the
distance of the control's audio from the reference's.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from reference import codec as ref_codec
from reference import prompt as ref_prompt
from reference import quant as ref_quant
from reference.model import Reference

from . import weights as weights_mod


def sample(requests, n: int, seed: int) -> List:
    """The longest finished request and n - 1 more drawn from the seed."""
    ok = [r for r in requests if r.error is None and r.codes is not None
          and len(r.codes) > 0]
    if not ok:
        return []
    ok.sort(key=lambda r: (-len(r.codes), r.t_done))
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, 11])
    rest = ok[1:]
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) \
        if rest else []
    return [ok[0]] + [rest[i] for i in sorted(pick)]


def formats(config: Dict, batch: int) -> Dict:
    f = config["formats"]
    return f.get(str(batch), f["default"])


def _code0_gap(ref_logits, tokens, k):
    kth = torch.topk(ref_logits, k, dim=-1).values[:, -1]
    got = ref_logits.gather(1, tokens[:, None].long())[:, 0]
    return float(torch.clamp(kth - got, min=0).max())


def _kth_token(logits, k):
    return torch.topk(logits, k, dim=-1).indices[:, -1]


def _resid_gap(ref_logits, tokens):
    best = ref_logits.max(-1).values
    got = ref_logits.gather(-1, tokens[..., None].long())[..., 0]
    return float((best - got).max())


def readings(config: Dict, seed: int, requests, speakers: Dict, top_k: int,
             batch: int, device, control: bool = False
             ) -> Tuple[Dict, Dict]:
    """({number: reading} of the program, {number: reading} of the control
    or {}) over `requests` (their codes and audio), from the seed's
    weights made again."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m = config["model"]
    raw = weights_mod.make(config, seed, device)
    fmt = formats(config, batch)
    ref = Reference(m, raw, fmt, ref_quant.exact)
    ctl = Reference(m, raw, fmt, ref_quant.fp8, share=ref) if control \
        else None
    text, codec_t = raw["assets"]["text"], raw["assets"]["codec"]
    got = {"gap_code0": 0.0, "gap_residual": 0.0, "audio_err": 0.0}
    low = {k: 0.0 for k in got} if control else {}
    with torch.no_grad():
        for r in requests:
            codes = torch.as_tensor(r.codes, device=device).long()
            prompt = ref_prompt.embeddings(text, codec_t, speakers[r.speaker],
                                           r.text, r.instruct)
            fb = ref_prompt.feedback(codec_t, ref.tts_pad, codes[:-1])
            k = 1 if r.greedy else top_k
            lg, hid = ref.talker_logits(prompt, fb)
            pl = ref.predictor_logits(hid, codes)
            got["gap_code0"] = max(got["gap_code0"],
                                   _code0_gap(lg, codes[:, 0], k))
            got["gap_residual"] = max(got["gap_residual"],
                                      _resid_gap(pl, codes[:, 1:]))
            wav = ref_codec.decode(m["codec_decoder"], raw["codec"], codes,
                                   ref_quant.exact)
            served = torch.as_tensor(np.asarray(r.audio, np.float32),
                                     device=device)
            err = (float((served - wav).abs().max())
                   if served.shape == wav.shape else float("inf"))
            got["audio_err"] = max(got["audio_err"], err)
            if ctl is None:
                continue
            c_lg, c_hid = ctl.talker_logits(prompt, fb)
            c_pl = ctl.predictor_logits(c_hid, codes)
            low["gap_code0"] = max(low["gap_code0"], _code0_gap(
                lg, _kth_token(c_lg, k), k))
            low["gap_residual"] = max(low["gap_residual"], _resid_gap(
                pl, c_pl.argmax(-1)))
            c_wav = ref_codec.decode(m["codec_decoder"], raw["codec"], codes,
                                     ref_quant.fp8)
            low["audio_err"] = max(low["audio_err"],
                                   float((c_wav - wav).abs().max()))
    del raw, ref, ctl
    return got, low


def judge(got: Dict, limits: Dict) -> Tuple[bool, Dict]:
    """(correct, {number: {"value", "limit"}}): each reading at or under
    its limit."""
    out, ok = {}, True
    for name, value in got.items():
        lim = limits[name]["limit"]
        out[name] = {"value": value, "limit": lim}
        ok = ok and value <= lim
    return ok, out
