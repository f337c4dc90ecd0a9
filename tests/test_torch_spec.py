"""Speculative multi-frame decoding in the port (qwen3_tts_tpu_torch/runtime/
spec.py) on the CPU, against the JAX package's runtime/spec.py on the same
weights (io/from_jax), and against the port's own sequential gen_frames.

As tests/test_spec.py does, every test rigs the sampler to a deterministic
draw (argmax with EOS masked) in both packages' generate and spec modules,
so that the sequential and speculative paths draw alike.  Held exactly:
codes, valid, n_emit and the per-lane cursors and positions (JAX with
uniform_cursor=False: its default is a fault, below).  Held within
LOGIT_ATOL / HIDDEN_ATOL: the carried logits and hidden state (f32 at
EngineConfig.tiny(); the two packages sum in other orders).  The port's
speculative stream, after uneven acceptance at per-lane cursors and a
sequential continuation, equals its all-sequential stream code for code.

The two faults of the JAX function that the port does not copy
(ROADMAP.md, Queue C) are named by test_jax_spec_faults_not_copied.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from qwen3_tts_tpu.core import protocol as JP
from qwen3_tts_tpu.core.config import EngineConfig as JC
from qwen3_tts_tpu.io.assets import Assets as JAssets
from qwen3_tts_tpu.models import predictor as jpred
from qwen3_tts_tpu.models import talker as jtalk
from qwen3_tts_tpu.runtime import generate as jgen
from qwen3_tts_tpu.runtime import spec as jspec
from qwen3_tts_tpu_torch.core import protocol as P
from qwen3_tts_tpu_torch.core.config import EngineConfig as TC
from qwen3_tts_tpu_torch.io.from_jax import (assets_from_arrays,
                                             draft_from_jax, tree_to_torch)
from qwen3_tts_tpu_torch.runtime import generate as tg
from qwen3_tts_tpu_torch.runtime import spec as tspec

CAP = 8          # prompt rows (= prompt_cap)
K = 4
LOGIT_ATOL = 1e-4
HIDDEN_ATOL = 1e-4
JSAMPLER = jgen.SamplerParams(temperature=jnp.float32(0.0),
                              top_k=jnp.int32(0), top_p=jnp.float32(1.0))
TSAMPLER = tg.SamplerParams(0.0, 0, 1.0)
# mismatches by lane for uneven acceptance: none, at 2, at 0, at 1
MISMATCH_AT = (K, 2, 0, 1)


def _jax_argmax(logits, key, t, k, p):
    return jnp.argmax(logits.at[..., JP.EOS].set(-jnp.inf),
                      axis=-1).astype(jnp.int32)


def _torch_argmax(logits, generator, t, k, p):
    masked = logits.float().clone()
    masked[..., P.EOS] = -torch.inf
    return torch.argmax(masked, dim=-1).to(torch.int32)


@pytest.fixture(autouse=True)
def rigged(monkeypatch):
    for mod, fn in ((jgen, _jax_argmax), (jspec, _jax_argmax),
                    (tg, _torch_argmax), (tspec, _torch_argmax)):
        monkeypatch.setattr(mod, "sample_logits", fn)


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(1)
    jcfg = JC.tiny()
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    jtp = jtalk.init_talker_params(jcfg.talker, k1)
    jpp = jpred.init_predictor_params(jcfg.predictor, k2)
    ja = JAssets.random_init(k3, text_rows=512, codec_rows=4096)
    arrays = {n: np.asarray(getattr(ja, n))
              for n in ("text_table", "codec_tables", "codec_tables_1024",
                        "proj_w", "proj_b", "tts_pad")}
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(jcfg=jcfg, jtp=jtp, jpp=jpp, jpack=ja.pack(), tcfg=TC.tiny(),
                ttp=tree_to_torch(to_np(jtp)), tpp=tree_to_torch(to_np(jpp)),
                tpack=assets_from_arrays(arrays).pack())


def _embeds(b):
    return np.array(jax.random.normal(jax.random.PRNGKey(1),
                                        (b, CAP, 2048)) * 0.02)


def _jstart(s, b):
    return jgen.prefill(s["jcfg"], s["jtp"], jnp.asarray(_embeds(b)),
                        jnp.full((b,), CAP, jnp.int32),
                        jax.random.PRNGKey(2))


def _tstart(s, b):
    return tg.prefill(s["tcfg"], s["ttp"], torch.from_numpy(_embeds(b)),
                      torch.full((b,), CAP, dtype=torch.int32),
                      torch.Generator().manual_seed(2))


def _jspec(s, state, draft, **kw):
    return jspec.gen_frames_spec(s["jcfg"], s["jtp"], s["jpp"], s["jpack"],
                                 state, jnp.asarray(draft), JSAMPLER,
                                 prompt_cap=CAP, **kw)


def _tspec(s, state, draft):
    return tspec.gen_frames_spec(s["tcfg"], s["ttp"], s["tpp"], s["tpack"],
                                 state, torch.from_numpy(np.asarray(draft)),
                                 TSAMPLER, CAP)


def _tframes(s, state, n, uniform_cursor=True):
    return tg.gen_frames(s["tcfg"], s["ttp"], s["tpp"], s["tpack"], state,
                         TSAMPLER, n, CAP, uniform_cursor)


@pytest.fixture(scope="module")
def seq(setup):
    """The port's sequential run of K + 8 frames at 4 lanes, one cursor;
    the JAX sequential codes of the first K (rigged by hand: monkeypatch is
    per test)."""
    saved = (jgen.sample_logits, tg.sample_logits)
    jgen.sample_logits, tg.sample_logits = _jax_argmax, _torch_argmax
    try:
        with torch.no_grad():
            _, tcodes, _ = _tframes(setup, _tstart(setup, 4), K + 8)
        _, jcodes, _ = jgen.gen_frames(
            setup["jcfg"], setup["jtp"], setup["jpp"], setup["jpack"],
            _jstart(setup, 4), JSAMPLER, n_frames=K, prompt_cap=CAP)
    finally:
        jgen.sample_logits, tg.sample_logits = saved
    jcodes = np.asarray(jcodes)
    np.testing.assert_array_equal(tcodes.numpy()[:, :K], jcodes)
    return tcodes.numpy()


def _uneven(codes):
    """The first K sequential frames with lane i's frames from
    MISMATCH_AT[i] on flipped."""
    draft = codes[:, :K].copy()
    for lane, at in enumerate(MISMATCH_AT):
        draft[lane, at:] ^= 1
    return draft


def _hold(got, want):
    """The port's spec result against the JAX one."""
    (ts, tcodes, tvalid, tn), (js, jcodes, jvalid, jn) = got, want
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(ts.cache.write_idx.numpy(),
                                  np.asarray(js.cache.write_idx))
    np.testing.assert_array_equal(ts.pos.numpy(), np.asarray(js.pos))
    np.testing.assert_array_equal(ts.done.numpy(), np.asarray(js.done))
    np.testing.assert_allclose(ts.logits.numpy(), np.asarray(js.logits),
                               rtol=0, atol=LOGIT_ATOL)
    np.testing.assert_allclose(ts.hidden.float().numpy(),
                               np.asarray(js.hidden, np.float32), rtol=0,
                               atol=HIDDEN_ATOL)


@pytest.mark.parametrize("case", ["full", "zero", "partial", "uneven"])
def test_spec_matches_jax(setup, seq, case):
    """Full (every draft right), zero (every code flipped), partial (frame
    0 right) and uneven (MISMATCH_AT) acceptance against JAX at per-lane
    cursors; the emitted frames are the sequential ones."""
    draft = {"full": seq[:, :K], "zero": seq[:, :K] ^ 1,
             "partial": np.concatenate([seq[:, :1], seq[:, 1:K] ^ 1], 1),
             "uneven": _uneven(seq)}[case]
    with torch.no_grad():
        got = _tspec(setup, _tstart(setup, 4), draft)
    want = _jspec(setup, _jstart(setup, 4), draft, uniform_cursor=False)
    _hold(got, want)
    n_emit = got[3].numpy()
    expect = {"full": [K] * 4, "zero": [1] * 4, "partial": [2] * 4,
              "uneven": [min(a + 1, K) for a in MISMATCH_AT]}[case]
    assert n_emit.tolist() == expect
    for lane, n in enumerate(n_emit):
        np.testing.assert_array_equal(got[1].numpy()[lane, :n],
                                      seq[lane, :n])
        assert got[2].numpy()[lane, :n].all()
        assert not got[2].numpy()[lane, n:].any()
    assert got[0].cache.write_idx.tolist() == [CAP + n for n in n_emit]
    assert got[0].step == K


def test_second_call_at_per_lane_cursors_matches_jax(setup, seq):
    """After uneven acceptance the lanes sit at different cursors; a second
    call (repeat_draft of each lane's last emitted frame) against JAX with
    uniform_cursor=False."""
    draft = _uneven(seq)
    with torch.no_grad():
        ts, tcodes, _, tn = _tspec(setup, _tstart(setup, 4), draft)
        last = tcodes[torch.arange(4), tn.long() - 1]
        got = _tspec(setup, ts, tspec.repeat_draft(last, K))
    js, jcodes, _, jn = _jspec(setup, _jstart(setup, 4), draft,
                               uniform_cursor=False)
    jlast = jcodes[jnp.arange(4), jn - 1]
    want = _jspec(setup, js, jspec.repeat_draft(jlast, K),
                  uniform_cursor=False)
    _hold(got, want)
    assert len(set(ts.cache.write_idx.tolist())) > 1
    assert got[0].step == 2 * K


def test_rollback_then_sequential_continues_stream(setup, seq):
    """Uneven acceptance, then 8 sequential frames at per-lane cursors:
    each lane's emitted frames and continuation equal its all-sequential
    stream (the rejected drafts' rows stay invisible), and JAX's
    sequential continuation from its own spec state gives the same codes."""
    draft = _uneven(seq)
    with torch.no_grad():
        ts, tcodes, _, tn = _tspec(setup, _tstart(setup, 4), draft)
        _, cont, valid = _tframes(setup, ts, 8, uniform_cursor=False)
    assert valid.all()
    for lane, n in enumerate(tn.tolist()):
        stream = np.concatenate([tcodes.numpy()[lane, :n],
                                 cont.numpy()[lane]])
        np.testing.assert_array_equal(stream, seq[lane, :n + 8])
    js, _, _, _ = _jspec(setup, _jstart(setup, 4), draft,
                         uniform_cursor=False)
    _, jcont, _ = jgen.gen_frames(setup["jcfg"], setup["jtp"], setup["jpp"],
                                  setup["jpack"], js, JSAMPLER, n_frames=2,
                                  prompt_cap=CAP, uniform_cursor=False)
    np.testing.assert_array_equal(cont.numpy()[:, :2], np.asarray(jcont))


def test_spec_equals_own_sequential_frames(setup, seq):
    """The port against itself: full acceptance carries the sequential
    state (codes exactly, logits within LOGIT_ATOL)."""
    with torch.no_grad():
        st, _, _ = _tframes(setup, _tstart(setup, 4), K)
        sp, codes, valid, n_emit = _tspec(setup, _tstart(setup, 4),
                                          seq[:, :K])
    assert n_emit.tolist() == [K] * 4 and valid.all()
    np.testing.assert_array_equal(codes.numpy(), seq[:, :K])
    np.testing.assert_array_equal(sp.pos.numpy(), st.pos.numpy())
    np.testing.assert_array_equal(sp.cache.write_idx.numpy(),
                                  st.cache.write_idx.numpy())
    np.testing.assert_allclose(sp.logits.numpy(), st.logits.numpy(),
                               rtol=0, atol=LOGIT_ATOL)


def test_eos_in_emitted_prefix(setup, monkeypatch):
    """Lane 0's target samples EOS at position 0: its frames are invalid
    and done sticks; the other lanes emit on; as JAX."""
    def jrig(logits, key, t, k, p):
        alt = _jax_argmax(logits, key, t, k, p)
        return jnp.where(jnp.arange(logits.shape[0]) == 0, JP.EOS, alt)

    def trig(logits, generator, t, k, p):
        alt = _torch_argmax(logits, generator, t, k, p)
        alt[0] = P.EOS
        return alt

    monkeypatch.setattr(jspec, "sample_logits", jrig)
    monkeypatch.setattr(tspec, "sample_logits", trig)
    draft = np.zeros((4, K, 16), np.int32)
    with torch.no_grad():
        got = _tspec(setup, _tstart(setup, 4), draft)
    want = _jspec(setup, _jstart(setup, 4), draft, uniform_cursor=False)
    _hold(got, want)
    st, _, valid, n_emit = got
    assert not valid[0].any() and st.done[0]
    for lane in (1, 2, 3):
        assert not st.done[lane] and valid[lane, :int(n_emit[lane])].all()


def test_repeat_draft_matches_jax():
    last = np.arange(32, dtype=np.int32).reshape(2, 16)
    got = tspec.repeat_draft(torch.from_numpy(last), 3)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jspec.repeat_draft(jnp.asarray(last), 3)))


def test_draft_head_from_jax_params(setup):
    """The JAX draft head's arrays through io/from_jax give the same
    drafted frames; the port's own seeded init has the JAX shapes."""
    jdp = jspec.init_draft_params(setup["jcfg"], jax.random.PRNGKey(7))
    hidden = np.array(jax.random.normal(jax.random.PRNGKey(8), (2, 2048)))
    last = np.ones((2, 16), np.int32)
    want = jspec.draft_frames(setup["jcfg"], jdp, setup["jpack"],
                              jnp.asarray(hidden), jnp.asarray(last), K)
    tdp = draft_from_jax(jax.tree_util.tree_map(np.asarray, jdp))
    got = tspec.draft_frames(setup["tcfg"], tdp, setup["tpack"],
                             torch.from_numpy(hidden),
                             torch.from_numpy(last), K)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    own = tspec.init_draft_params(setup["tcfg"],
                                  torch.Generator().manual_seed(7))
    assert {n: tuple(t.shape) for n, t in own.items()} == \
        {n: tuple(np.shape(a)) for n, a in jdp.items()}
    with pytest.raises(ValueError):
        draft_from_jax({"trunk": np.zeros((2, 2), np.float32)})


def test_jax_spec_faults_not_copied(setup, seq):
    """ROADMAP Queue C's two faults of qwen3_tts_tpu/runtime/spec.py.
    (1) `step = state.step + jnp.min(n_emit)` (spec.py:163): after uneven
    acceptance prompt_cap + step falls below the fastest lane's cursor, so
    a capacity check on it passes too late; the port's step (+K) bounds
    every cursor.  (2) the default uniform_cursor=True (spec.py:55): a
    second call after uneven acceptance writes every lane's rows at
    write_idx[0]; lane 1's carried logits then leave the per-lane ones,
    and the port (always per lane) emits lane 1's sequential frames."""
    draft = _uneven(seq)
    js, _, _, jn = _jspec(setup, _jstart(setup, 4), draft)
    jcursor = np.asarray(js.cache.write_idx)
    assert CAP + int(js.step) < jcursor.max()             # fault (1)
    with torch.no_grad():
        ts, _, _, tn = _tspec(setup, _tstart(setup, 4), draft)
    assert CAP + ts.step >= max(ts.cache.write_idx.tolist())
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))

    # (2): lane 1 (cursor CAP + 3) drafts its next sequential frames
    nxt = np.stack([seq[lane, n:n + K] for lane, n in
                    enumerate(tn.tolist())])
    jdef = _jspec(setup, js, nxt)                         # uniform_cursor
    with torch.no_grad():
        tgot = _tspec(setup, ts, nxt)
    n1 = int(tgot[3][1])
    np.testing.assert_array_equal(tgot[1].numpy()[1, :n1],
                                  seq[1, 3:3 + n1])
    assert int(tgot[3][1]) == K
    # JAX's default attends lane 1's stale row at CAP + 3 and writes its
    # new rows one slot off: its carried logits leave the port's
    jgap = np.abs(np.asarray(jdef[0].logits)[1]
                  - tgot[0].logits.numpy()[1]).max()
    assert jgap > 100 * LOGIT_ATOL, jgap
