"""The traffic generator: deterministic per seed, the mix's parameters,
the same sizes in the same order and the same multiset of voices and
arrival gaps for every seed."""

import json
from collections import Counter

import numpy as np
import pytest

from harness import traffic
from tiny import BENCH

MIXES = ["online_closed", "stream_closed"]


def load(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_pool(name):
    mix = load(name)
    a = traffic.pool(mix, 2**31 + 99)
    b = traffic.pool(mix, 2**31 + 99)
    assert [(r.text, r.speaker, r.instruct, r.frames) for r in a] == \
        [(r.text, r.speaker, r.instruct, r.frames) for r in b]


@pytest.mark.parametrize("name", MIXES)
def test_seeds_share_the_multiset(name):
    mix = load(name)
    a = traffic.pool(mix, 1)
    b = traffic.pool(mix, 2**32 + 5)
    for key in ("frames", "rows", "speaker", "instruct", "greedy", "gap_s"):
        assert Counter(getattr(r, key) for r in a) == \
            Counter(getattr(r, key) for r in b)
    # the sizes in one order for every seed; the texts and voices not
    assert [r.frames for r in a] == [r.frames for r in b]
    assert [r.rows for r in a] == [r.rows for r in b]
    assert [r.text for r in a] != [r.text for r in b]
    assert [r.speaker for r in a] != [r.speaker for r in b]


@pytest.mark.parametrize("name", MIXES)
def test_parameters(name):
    mix = load(name)
    pool = traffic.pool(mix, 7)
    assert len(pool) == mix["pool"]
    lo, hi = mix["speech_s"]
    hz = mix["frame_hz"]
    frames = np.array([r.frames for r in pool])
    assert frames.min() >= round(lo * hz) and frames.max() <= round(hi * hz)
    # uniform over the durations: the mean is the midpoint
    assert abs(frames.mean() - (lo + hi) / 2 * hz) <= 0.5
    # a text of words_per_s x tokens_per_word tokens a second of speech
    per_s = mix["words_per_s"] * mix["tokens_per_word"]
    for r in pool:
        if r.instruct is None:
            fixed = r.rows - len(r.text)
            assert abs(len(r.text) - r.frames / hz * per_s) <= 1.0
            assert fixed == traffic.ref_prompt.n_rows("", None)
    assert max(r.rows for r in pool) <= mix.get("bucket", 64)
    share = np.mean([r.instruct is not None for r in pool])
    assert abs(share - mix["instruct_share"]) < 1.0 / len(pool) + 1e-9
    counts = Counter(r.speaker for r in pool)
    assert set(counts) == set(mix["speakers"])
    assert max(counts.values()) - min(counts.values()) <= 1   # evenly
    greedy = np.mean([r.greedy for r in pool])
    assert abs(greedy - mix["greedy_share"]) < 1.0 / len(pool) + 1e-9
    assert all(r.gap_s == 0.0 for r in pool)                  # closed loop
    # every parameter of the request law has a source or a reason
    named = set(mix["sources"]) | {k.split()[0] for k in mix["assumed"]}
    assert named >= {"speech_s", "words_per_s", "frame_hz",
                     "tokens_per_word", "speakers", "sampler",
                     "instruct_share", "speaker_zipf"}


def test_sizes_spread_over_every_stretch():
    """Every 16 consecutive requests span most of the size range: the load
    does not come in clumps of long requests."""
    frames = np.array([r.frames for r in traffic.pool(load("online_closed"),
                                                      3)])
    for i in range(0, len(frames) - 16):
        win = frames[i:i + 16]
        assert win.max() - win.min() >= 0.75 * (frames.max() - frames.min())
        assert abs(win.mean() - frames.mean()) < 0.12 * frames.mean()
    assert sorted(traffic.spread_order(128)) == list(range(128))


@pytest.mark.parametrize("arrivals,rate", [
    ({"law": "poisson", "rate_per_s": 8.0}, 8.0),
    ({"law": "bursts", "rate_per_s": 8.0, "burst": 4}, 8.0)])
def test_open_arrivals(arrivals, rate):
    mix = dict(load("online_closed"), arrivals=arrivals, pool=256)
    a = traffic.pool(mix, 11)
    b = traffic.pool(mix, 2**35 + 11)
    gaps = np.array([r.gap_s for r in a])
    # the law's rate over the pool, the same gaps for every seed
    assert len(gaps) / gaps.sum() == pytest.approx(rate, rel=0.02)
    assert sorted(gaps) == sorted(r.gap_s for r in b)
    assert list(gaps) != [r.gap_s for r in b]
    if arrivals["law"] == "bursts":
        k = arrivals["burst"]
        assert np.all(gaps[np.arange(len(gaps)) % k != 0] == 0.0)
        assert np.all(gaps[::k] > 0.0)
    else:
        assert np.all(gaps > 0.0)


def test_rows_count_the_protocol():
    """A request's rows are what the prompt protocol makes of its text."""
    from reference import prompt as ref_prompt
    mix = dict(load("online_closed"), instruct_share=0.5,
               instructions=["Whisper softly.", "Speak slowly."])
    pool = traffic.pool(mix, 3)
    assert {r.instruct for r in pool} == {None, *mix["instructions"]}
    for r in pool[:50]:
        assert r.rows == len(ref_prompt.rows(r.text, r.instruct))
        assert r.rows == ref_prompt.n_rows(r.text, r.instruct)
