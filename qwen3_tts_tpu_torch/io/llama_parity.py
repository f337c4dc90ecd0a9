"""Cross-implementation logit parity vs llama.cpp (real-checkpoint drill).
Counterpart of qwen3_tts_tpu/io/llama_parity.py.

The reference drives the talker/predictor GGUFs through llama.cpp, which
exposes both logits and the final hidden state per decode (the reference's
src/models/llama/mod.rs:459-466).  A GGUF import bug on our side (weight
transpose, qk-norm placement, rope theta, M-RoPE sections) would otherwise
surface only as bad audio; this harness turns it into a numeric diff:

  1. `make_inputs(path)` (here, offline): seeded random embedding prompt +
     per-step feedback embeddings, saved as npz (the JAX package's seeds
     and arrays, so one inputs file serves both packages).
  2. `scripts/dump_llama_logits.py` (any machine with the llama.cpp runtime
     libs): feeds the same npz through libllama via ctypes exactly as the
     reference does (M-RoPE planar positions, embeddings=1) and records
     prefill/step logits + hidden states.
  3. `compare_talker(gguf, inputs, dump)` (here): runs the port's talker on
     the same inputs on `device` (the card by default: the prefill kernel,
     then the decode attention kernel a layer a step) and reports max/mean
     deviations.

Our talker materializes only the codec head slice [0, 2160) of the LM head
(engine.rs:555 samples nothing beyond it), so logits compare on that slice;
hidden states compare on all 2048 dims (llama.cpp's `embeddings` output is
the post-final-norm hidden, as models/talker.talker_prefill's).

The pass rule is the JAX package's: worst relative deviation <= rel_tol
(5e-2) and top-1 agreement >= 0.99 on every logits entry.  `tie_tol`
(off by default) excuses a top-1 miss whose two picks lie within tie_tol
of max |logit| of each other on both sides (`top1_misses`): a near tie
that another sum order may flip, which the JAX rule counts as a miss.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

PROMPT_ROWS = 48      # long enough to exercise every mrope section
N_STEPS = 8           # autoregressive steps after prefill
EMBED_SCALE = 0.7     # random-normal scale; keeps llama.cpp activations sane


def make_inputs(path, d_model: int = 2048, seed: int = 0,
                rows: int = PROMPT_ROWS, steps: int = N_STEPS) -> Dict:
    """Deterministic parity inputs, shared by both sides."""
    rng = np.random.default_rng(seed)
    data = {
        "embeds": (rng.standard_normal((rows, d_model)) * EMBED_SCALE
                   ).astype(np.float32),
        "step_embeds": (rng.standard_normal((steps, d_model)) * EMBED_SCALE
                        ).astype(np.float32),
        "seed": np.int64(seed),
    }
    if path is not None:
        np.savez(path, **data)
    return data


@torch.no_grad()
def run_our_talker(cfg, params, inputs: Dict, device="cuda"
                   ) -> Dict[str, np.ndarray]:
    """Our side of the diff: prefill + N decode steps on the parity inputs,
    with `params` on `device` (the JAX function's schedule: a cache of
    S + N + 8 slots, every step at prompt_cap = S).

    Returns the same npz schema the llama.cpp dumper writes, so the two
    sides compare symmetrically (and the harness itself is testable offline
    by diffing our model against itself)."""
    from ..models import talker as talker_lib
    dev = torch.device(device)
    embeds = torch.as_tensor(np.asarray(inputs["embeds"], np.float32),
                             device=dev)[None]                   # [1, S, D]
    steps = np.asarray(inputs["step_embeds"], np.float32)
    s = embeds.shape[1]
    cache = talker_lib.init_talker_cache(cfg, 1, s + len(steps) + 8, dev,
                                         params)
    lengths = torch.tensor([s], dtype=torch.int32, device=dev)
    logits, hidden, cache = talker_lib.talker_prefill(cfg, params, embeds,
                                                      lengths, cache)
    out = {"prefill_logits": logits[0].float().cpu().numpy(),
           "prefill_hidden": hidden[0].float().cpu().numpy()}
    sl, sh = [], []
    for i in range(len(steps)):
        pos = torch.tensor([s + i], dtype=torch.int32, device=dev)
        logits, hidden, cache = talker_lib.talker_decode_step(
            cfg, params, torch.as_tensor(steps[i], device=dev)[None], pos,
            cache, prompt_cap=s)
        sl.append(logits[0].float().cpu().numpy())
        sh.append(hidden[0].float().cpu().numpy())
    out["step_logits"] = np.stack(sl)
    out["step_hidden"] = np.stack(sh)
    return out


def _pairs(ours: Dict, theirs: Dict):
    """(tag, ours, theirs) of every compared entry, steps cut to the
    shorter side's."""
    yield "prefill_logits", ours["prefill_logits"], theirs["prefill_logits"]
    yield "prefill_hidden", ours["prefill_hidden"], theirs["prefill_hidden"]
    if "step_logits" in ours and "step_logits" in theirs:
        k = min(len(ours["step_logits"]), len(theirs["step_logits"]))
        yield "step_logits", ours["step_logits"][:k], \
            theirs["step_logits"][:k]
        yield "step_hidden", ours["step_hidden"][:k], \
            theirs["step_hidden"][:k]


def _cut(tag: str, a, b, logit_slice: int):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    n = min(a.shape[-1], b.shape[-1], logit_slice if "logits" in tag
            else a.shape[-1])
    return a[..., :n], b[..., :n]


def compare_dumps(ours: Dict, theirs: Dict, logit_slice: int = 2160,
                  ) -> Dict[str, float]:
    """Numeric diff between our outputs and a llama.cpp dump.

    Logits compare on the codec slice [0, logit_slice) (our head only
    materializes those rows); top-1 agreement within the slice is reported
    separately because that is what sampling actually consumes."""
    stats: Dict[str, float] = {}
    for tag, a, b in _pairs(ours, theirs):
        a, b = _cut(tag, a, b, logit_slice)
        err = np.abs(a - b)
        denom = np.maximum(np.abs(b).max(), 1e-6)
        stats[f"{tag}_max_abs"] = float(err.max())
        stats[f"{tag}_rel"] = float(err.max() / denom)
        if "logits" in tag:
            stats[f"{tag}_top1_match"] = float(np.mean(
                np.argmax(a, axis=-1) == np.argmax(b, axis=-1)))
    return stats


def top1_misses(ours: Dict, theirs: Dict, logit_slice: int = 2160
                ) -> List[Tuple[str, int, int, int, float, float]]:
    """Every row whose top-1 differs between the two sides: (tag, row,
    our pick a, their pick b, how far a leads b in our logits, how far b
    leads a in theirs), the leads over max |logit| of the two sides."""
    out = []
    for tag, a, b in _pairs(ours, theirs):
        if "logits" not in tag:
            continue
        a, b = _cut(tag, a, b, logit_slice)
        a2, b2 = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
        scale = max(float(np.abs(a).max()), float(np.abs(b).max()), 1e-6)
        for r in range(a2.shape[0]):
            pa, pb = int(np.argmax(a2[r])), int(np.argmax(b2[r]))
            if pa != pb:
                out.append((tag, r, pa, pb,
                            float(a2[r, pa] - a2[r, pb]) / scale,
                            float(b2[r, pb] - b2[r, pa]) / scale))
    return out


def compare_talker(gguf_path, inputs_path, dump_path,
                   rel_tol: float = 5e-2, device="cuda",
                   tie_tol: Optional[float] = None) -> Dict[str, float]:
    """End-to-end: load the talker GGUF with our loader onto `device`, run
    the parity inputs, diff against the llama.cpp dump.  Raises
    AssertionError with the full stats when outside tolerance (bf16-vs-ggml
    rounding budgets ~1e-2 relative; a transposed weight shows up as O(1)).
    tie_tol: excuse top-1 misses at near ties (module docstring); the
    stats then hold `top1_excused`, the count excused."""
    from ..core.config import TalkerConfig
    from . import weights as weights_io
    cfg, params = weights_io.load_talker_gguf(gguf_path, TalkerConfig(),
                                              device)
    inputs = dict(np.load(inputs_path))
    theirs = dict(np.load(dump_path))
    ours = run_our_talker(cfg, params, inputs, device)
    stats = compare_dumps(ours, theirs)
    if tie_tol is not None:
        misses = top1_misses(ours, theirs)
        stats["top1_excused"] = float(sum(
            1 for m in misses if max(m[4], m[5]) <= tie_tol))
        for tag, a, _ in _pairs(ours, theirs):
            if "logits" in tag:
                bad = sum(1 for m in misses
                          if m[0] == tag and max(m[4], m[5]) > tie_tol)
                stats[f"{tag}_top1_match"] = 1.0 - bad / int(
                    np.prod(np.shape(a)[:-1]))
    worst = max(v for k, v in stats.items() if k.endswith("_rel"))
    top1 = min((v for k, v in stats.items() if k.endswith("top1_match")),
               default=1.0)
    if worst > rel_tol or top1 < 0.99:
        raise AssertionError(
            f"talker logit parity vs llama.cpp FAILED (rel {worst:.3g} > "
            f"{rel_tol}, top1 {top1:.3f}): {stats}")
    return stats
