"""qwen3_tts_tpu_torch.ops against qwen3_tts_tpu.ops on the same seeded
numpy inputs, in f32 (atol 1e-5: the two frameworks sum in other orders),
plus the sampler: greedy equal, sampled held to the same kept set and
probabilities (torch and jax.random draw different numbers)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from qwen3_tts_tpu.ops import attention as ja
from qwen3_tts_tpu.ops import norms as jn
from qwen3_tts_tpu.ops import quant as jq
from qwen3_tts_tpu.ops import rope as jr
from qwen3_tts_tpu.ops import sampling as js
from qwen3_tts_tpu_torch.ops import attention as ta
from qwen3_tts_tpu_torch.ops import norms as tn
from qwen3_tts_tpu_torch.ops import quant as tq
from qwen3_tts_tpu_torch.ops import rope as tr
from qwen3_tts_tpu_torch.ops import sampling as ts

ATOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               atol=atol, rtol=1e-5)


def test_rms_norm():
    rng = _rng()
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    _close(tn.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           jn.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))


def test_rope_tables_and_apply():
    np.testing.assert_array_equal(tr.inv_frequencies(128, 1e6),
                                  jr.inv_frequencies(128, 1e6))
    np.testing.assert_array_equal(tr.section_ids((24, 20, 20, 0)),
                                  jr.section_ids((24, 20, 20, 0)))
    rng = _rng(1)
    pos = rng.integers(0, 4000, (2, 7)).astype(np.int32)
    pos4 = np.stack([pos, pos + 1, pos + 2, np.zeros_like(pos)], -1)
    inv = tr.inv_frequencies(16, 1e6)
    sec = tr.section_ids((3, 3, 2, 0))
    tc, tsn = tr.mrope_cos_sin(torch.from_numpy(pos4), torch.from_numpy(inv),
                               torch.from_numpy(sec))
    jc, jsn = jr.mrope_cos_sin(jnp.asarray(pos4), jnp.asarray(inv),
                               jnp.asarray(sec))
    _close(tc, jc, 1e-4)     # angles up to ~4000 rad: f32 sin/cos ulps
    _close(tsn, jsn, 1e-4)
    tc, tsn = tr.rope_cos_sin(torch.from_numpy(pos), torch.from_numpy(inv))
    jc, jsn = jr.rope_cos_sin(jnp.asarray(pos), jnp.asarray(inv))
    _close(tc, jc, 1e-4)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    c = np.cos(rng.standard_normal((2, 7, 16))).astype(np.float32)
    s = np.sin(rng.standard_normal((2, 7, 16))).astype(np.float32)
    _close(tr.apply_rope(*map(torch.from_numpy, (x, c, s))),
           jr.apply_rope(*map(jnp.asarray, (x, c, s))))


@pytest.mark.parametrize("start,s,prompt_cap", [
    ([0, 0], 32, 32), ([40, 40], 1, 32), ([7, 19], 5, 16), ([70, 3], 1, 64)])
def test_history_mask(start, s, prompt_cap):
    lengths = np.asarray([9, 32], np.int32)
    got = ta.history_mask(torch.from_numpy(lengths), prompt_cap,
                          torch.tensor(start, dtype=torch.int32), s, 96)
    want = ja.history_mask(jnp.asarray(lengths), prompt_cap,
                           jnp.asarray(start, jnp.int32), s, 96)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gqa_attend():
    rng = _rng(2)
    q = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 40, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, 40, 16)).astype(np.float32)
    lengths = np.asarray([5, 20], np.int32)
    mask = np.array(ja.history_mask(jnp.asarray(lengths), 24,
                                      jnp.int32(30), 3, 40))
    _close(ta.gqa_attend(*map(torch.from_numpy, (q, k, v, mask))),
           ja.gqa_attend(*map(jnp.asarray, (q, k, v, mask))))


def test_update_cache_in_place():
    rng = _rng(3)
    cache = rng.standard_normal((2, 2, 12, 8)).astype(np.float32)
    new = rng.standard_normal((2, 3, 2, 8)).astype(np.float32)
    t = torch.from_numpy(cache.copy())
    out = ta.update_cache(t, torch.from_numpy(new), torch.tensor([4]))
    assert out.data_ptr() == t.data_ptr()
    _close(t, ja.update_cache(jnp.asarray(cache), jnp.asarray(new),
                              jnp.int32(4)), 0)


def test_head_matmuls():
    rng = _rng(4)
    x = rng.standard_normal((3, 32)).astype(np.float32)
    w = rng.standard_normal((32, 24)).astype(np.float32)
    head = rng.standard_normal((50, 32)).astype(np.float32)
    tx, tw, th = map(torch.from_numpy, (x, w, head))
    _close(tq.matmul(tx, tw), jq.matmul(jnp.asarray(x), jnp.asarray(w)))
    _close(tq.head_matmul(tx, th),
           jq.head_matmul(jnp.asarray(x), jnp.asarray(head)))
    _close(tq.head_matmul_slice(tx, th, 10, 16),
           jq.head_matmul_slice(jnp.asarray(x), jnp.asarray(head), 10, 16))


def test_greedy_sampling_equal_with_ties():
    rng = _rng(5)
    logits = rng.standard_normal((6, 2160)).astype(np.float32)
    logits[0, [7, 900]] = 9.0            # tie: lowest index wins
    got = ts.sample_logits(torch.from_numpy(logits), torch.Generator(),
                           0.0, 40, 0.9)
    want = js.sample_logits(jnp.asarray(logits), jax.random.PRNGKey(0),
                            0.0, 40, 0.9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0] == 7 and got.dtype == torch.int32


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.7, 40, 0.9), (1.0, 0, 0.5), (0.5, 5, 1.0)])
def test_sampled_distribution_matches_jax(temperature, top_k, top_p):
    """Kept set and probabilities of the port's filtered distribution
    against the frequencies of 20000 JAX draws (4-sigma bound)."""
    rng = _rng(6)
    logits = (rng.standard_normal(64) * 2).astype(np.float32)
    order, probs = ts.filtered_distribution(torch.from_numpy(logits),
                                            temperature, top_k, top_p)
    p = np.zeros(64)
    p[order.numpy()] = probs.numpy()
    n = 20000
    keys = jax.random.split(jax.random.PRNGKey(1), n)
    draws = np.asarray(jax.vmap(lambda k: js.sample_logits(
        jnp.asarray(logits), k, temperature, top_k, top_p))(keys))
    freq = np.bincount(draws, minlength=64) / n
    assert set(np.flatnonzero(freq)) <= set(np.flatnonzero(p))
    assert np.all(np.abs(freq - p) <= 4 * np.sqrt(p * (1 - p) / n) + 1e-3)
    # the port's own draws come from the same distribution
    g = torch.Generator().manual_seed(0)
    tdraws = ts.sample_logits(torch.from_numpy(logits).expand(n, 64), g,
                              temperature, top_k, top_p).numpy()
    tfreq = np.bincount(tdraws, minlength=64) / n
    assert set(np.flatnonzero(tfreq)) <= set(np.flatnonzero(p))
    assert np.all(np.abs(tfreq - p) <= 4 * np.sqrt(p * (1 - p) / n) + 1e-3)
