"""The one traffic generator: a mix file (benchmark/traffic/<mix>.json) of
parameters in, a seeded pool of requests out.

Every seed gets the same sizes in the same order, and the same multiset
of voices, instructions and arrival gaps; the seed orders those and draws
the characters of the texts.  A pool of `pool` requests takes

- speech durations at the `pool` evenly spaced quantiles of a uniform law
  over `speech_s` = [lo, hi] seconds; each request's frame budget is its
  duration times `frame_hz`, and its text `words_per_s` x
  `tokens_per_word` tokens a second of it (one character a token with the
  development tokenizer), plus the fixed rows of the prompt protocol
  (reference/prompt.py);
- voices from `speakers`, in counts proportional to 1 / rank^speaker_zipf
  (0: evenly), largest remainders;
- one of `instructions` on a share `instruct_share` of the requests (the
  instructions in turn), and greedy decoding on a share `greedy_share`;
- `arrivals`: {"law": "closed", "clients": n} (n clients, each sending its
  next request when its last one is answered: no gaps), {"law":
  "poisson", "rate_per_s": r} (gaps at the evenly spaced quantiles of the
  exponential law of rate r), or {"law": "bursts", "rate_per_s": r,
  "burst": k} (k requests at once, the bursts' gaps exponential at r / k).

Durations are laid out in a low-discrepancy order (the ranks of k * phi
mod 1), so that every stretch of consecutive requests spans the range of
sizes; the order is the same for every seed, because in a closed loop it
decides which requests run side by side, and so the work of a window.
Voices, instructions, greedy flags and gaps are shuffled by the seed, each
by a stream of its own.  The clients take requests in pool order,
cycling.

A mix's `sources` name where each parameter comes from and its `assumed`
why a parameter with no source takes its value; the generator reads
neither.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from reference import prompt as ref_prompt

LETTERS = "abcdefghijklmnopqrstuvwxyz      "
PHI = (math.sqrt(5.0) - 1.0) / 2.0


@dataclass
class Request:
    index: int
    text: str
    speaker: str
    instruct: Optional[str]
    frames: int
    greedy: bool
    rows: int
    gap_s: float = 0.0              # arrival gap before it (open laws)
    # filled by the client
    t_submit: float = 0.0           # when it was sent, or due (open laws)
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    gaps: List[float] = field(default_factory=list)
    served_frames: int = 0
    eos: bool = False
    error: Optional[str] = None
    codes: Optional[np.ndarray] = None        # [frames, 16] int32
    audio: Optional[np.ndarray] = None        # [frames * 2000] f32
    prefill_ms: Optional[float] = None


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def _counts(weights: np.ndarray, n: int) -> np.ndarray:
    share = weights / weights.sum() * n
    out = np.floor(share).astype(int)
    rest = np.argsort(-(share - out), kind="stable")[: n - out.sum()]
    out[rest] += 1
    return out


def spread_order(n: int) -> np.ndarray:
    """A permutation of range(n): position k takes the rank of k * phi
    mod 1, so that neighbours lie far apart in rank."""
    key = np.mod(np.arange(n) * PHI, 1.0)
    return np.argsort(np.argsort(key, kind="stable"), kind="stable")


def arrival_gaps(arrivals: Dict, n: int, rng) -> np.ndarray:
    """The gap before each of n requests, in pool order: the law's
    evenly spaced quantiles, shuffled by rng."""
    law = arrivals["law"]
    if law == "closed":
        return np.zeros(n)
    rate = float(arrivals["rate_per_s"])
    k = int(arrivals["burst"]) if law == "bursts" else 1
    if law not in ("poisson", "bursts") or k < 1:
        raise ValueError(f"unknown arrival law {arrivals!r}")
    starts = -(n // -k)
    gaps = np.zeros(n)
    gaps[::k] = rng.permutation(-np.log1p(-_quantiles(starts)) * k / rate)
    return gaps


def pool(mix: Dict, seed: int) -> List[Request]:
    n = int(mix["pool"])
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, 7])
    lo, hi = mix["speech_s"]
    speech = lo + _quantiles(n) * (hi - lo)
    speech = speech[spread_order(n)]
    frames = np.maximum(np.rint(speech * mix["frame_hz"]), 1).astype(int)
    tokens = np.rint(speech * mix["words_per_s"]
                     * mix["tokens_per_word"]).astype(int)
    spk = mix["speakers"]
    counts = _counts(1.0 / np.arange(1, len(spk) + 1)
                     ** mix.get("speaker_zipf", 0.0), n)
    voices = np.repeat(np.arange(len(spk)), counts)
    n_instr = int(round(n * mix.get("instruct_share", 0.0)))
    instr = np.full(n, -1)
    if n_instr:
        instr[:n_instr] = np.arange(n_instr) % len(mix["instructions"])
    greedy = np.zeros(n, bool)
    greedy[: int(round(n * mix["greedy_share"]))] = True
    voices, instr, greedy = (rng.permutation(a)
                             for a in (voices, instr, greedy))
    gaps = arrival_gaps(mix.get("arrivals", {"law": "closed"}), n, rng)
    out = []
    for i in range(n):
        ins = mix["instructions"][instr[i]] if instr[i] >= 0 else None
        n_chars = max(int(tokens[i]), mix.get("min_chars", 4))
        text = "".join(rng.choice(list(LETTERS), n_chars))
        out.append(Request(index=i, text=text, speaker=spk[voices[i]],
                           instruct=ins, frames=int(frames[i]),
                           greedy=bool(greedy[i]),
                           rows=ref_prompt.n_rows(text, ins),
                           gap_s=float(gaps[i])))
    return out
