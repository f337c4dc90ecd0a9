"""The port's jitted ONNX walk (io/onnx_exec.OnnxExecutor.jitted) on the
CPU, where it stops at the plan: against the port's own eager walk (`run`)
bit for bit, through the decoder (a multi-chunk stream run twice,
decode_batch) and both encoders, and against the JAX executor's
`jitted()` / jax.jit classes on the same fixture graphs within
tests/test_torch_onnx.py's tolerances (FLOAT_TOL for floats, integers
exactly, EMB_TOL for speaker embeddings).  Also the plan cache's keys: a
second call of a signature builds no plan, a changed shape, dtype or batch
builds its own, the bound evicts least recently used first, and HOST
outputs come back as `run` gives them.  One torch thread; the CUDA graph
replays are checked on the card (tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_onnx_fixtures as tfx
from qwen3_tts_tpu.io import onnx_lite as jlite
from qwen3_tts_tpu.io.onnx_exec import OnnxExecutor as JEx
from qwen3_tts_tpu.models.codec.onnx_decoder import OnnxAudioEncoder as JAE
from qwen3_tts_tpu.models.codec.onnx_decoder import OnnxSpeakerEncoder as JSE
from qwen3_tts_tpu_torch.io import onnx_exec
from qwen3_tts_tpu_torch.io import onnx_lite as tlite
from qwen3_tts_tpu_torch.io.onnx_exec import OnnxExecutor as TEx
from qwen3_tts_tpu_torch.models.codec.onnx_decoder import (
    OnnxAudioEncoder, OnnxSpeakerEncoder, OnnxStreamingDecoder, _next_name)
from test_torch_onnx import EMB_TOL, _np, _same

torch.set_num_threads(1)

ENC = tfx.EncDims(hop=16, d=8)
CHUNKS = (1, 2, 3)            # a stream's chunk sizes: 6 frames


def _decoder(data=None):
    data = data if data is not None else tfx.build_decoder(tfx.MINI,
                                                           seed=0)[0]
    return OnnxStreamingDecoder(TEx(tlite.read_onnx_graph(data), "cpu"))


def _codes(shape, seed):
    return np.random.default_rng(seed).integers(0, tfx.VOCAB, size=shape)


def _feeds(dec, codes, state, final=False):
    return {"audio_codes": dec._frames(codes)[None],
            "is_last": dec._is_last[final], **state}


def _device_outs(out):
    return {k: v for k, v in out.items() if isinstance(v, torch.Tensor)}


def _eager_vmap(ex, feeds):
    """decode_batch's former walk: torch.func.vmap over `run`, its HOST
    outputs unbatched beside the vmapped device outputs, in the graph's
    output order."""
    host = {}

    def lane(lane_feeds):
        out = ex.run(lane_feeds)
        host.update((k, v) for k, v in out.items()
                    if not isinstance(v, torch.Tensor))
        return _device_outs(out)

    out = torch.func.vmap(lane)(feeds)
    out.update(host)
    return {n: out[n] for n in ex.output_names}


def _bit_equal(got, want):
    """The same names in the same order, each value of the same kind and
    bit for bit equal."""
    assert list(got) == list(want)
    for k in want:
        assert type(got[k]) is type(want[k]), (k, type(got[k]))
        if isinstance(want[k], torch.Tensor):
            assert got[k].dtype == want[k].dtype, k
            assert torch.equal(got[k], want[k]), k
        else:
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------------ jitted against run
def _case_stream():
    """A 3-chunk stream, run twice: jitted against run at each call, on
    the same feeds (the first stream plans, the second runs the plans)."""
    dec = _decoder()
    fn = dec.ex.jitted()
    codes = _codes((6, tfx.NB), 1)
    for rep in range(2):
        state, lo = dec.create_state(), 0
        for n in CHUNKS:
            feeds = _feeds(dec, codes[lo:lo + n], state,
                           final=lo + n == 6)
            plans = dec.ex.stats["plans"]
            got = fn(feeds)
            _bit_equal(got, dec.ex.run(feeds))
            assert dec.ex.stats["plans"] == plans + (rep == 0)
            state = {k: got[_next_name(k)] for k in dec.state_names}
            lo += n
    assert dec.ex.stats["plans"] == len(CHUNKS)
    assert dec.ex.stats["plan_runs"] == len(CHUNKS)


def _case_decode_batch():
    """decode_batch of 3 lanes with per-lane finals, two chunks, against
    the same lanes through vmap of run; then each lane's waveform against
    decode of that lane alone."""
    dec = _decoder()
    codes = _codes((3, 4, tfx.NB), 2)
    finals = np.asarray([True, False, True])
    states = [dec.create_state() for _ in range(3)]
    for lo in (0, 2):
        feeds = {"audio_codes": torch.stack([dec._frames(codes[i, lo:lo + 2])
                                             for i in range(3)])[:, None],
                 "is_last": torch.stack([dec._is_last[bool(f) and lo == 2]
                                         for f in finals])}
        feeds.update({k: torch.stack([s[k] for s in states])
                      for k in dec.state_names})
        _bit_equal(dec.ex.jitted().vmap(feeds), _eager_vmap(dec.ex, feeds))
        wavs, new = dec.decode_batch(codes[:, lo:lo + 2], states,
                                     is_final=finals & (lo == 2))
        for i in range(3):
            alone, _ = dec.decode(codes[i, lo:lo + 2], states[i],
                                  bool(finals[i]) and lo == 2)
            np.testing.assert_allclose(wavs[i], alone, rtol=1e-5, atol=1e-5)
        states = new
    assert dec.ex.stats["plans"] == 2 + 2      # vmap B = 3, one lane


def _case_audio_encoder():
    data, _ = tfx.build_encoder(ENC, seed=2)
    ex = TEx(tlite.read_onnx_graph(data), "cpu")
    for n in (11, 11, 7):
        feeds = {"input_values": torch.from_numpy(
            (np.random.default_rng(n).standard_normal((1, 16 * n + 5))
             * 0.2).astype(np.float32))}
        _bit_equal(ex.jitted()(feeds), ex.run(feeds))
    assert (ex.stats["plans"], ex.stats["plan_runs"]) == (2, 1)


def _case_speaker_encoder():
    data, _ = tfx.build_speaker(tfx.SpkDims(), seed=4)
    ex = TEx(tlite.read_onnx_graph(data), "cpu")
    for f in (37, 37, 50):
        feeds = {"mels": torch.from_numpy(np.random.default_rng(f)
                                          .standard_normal((1, f, 128))
                                          .astype(np.float32))}
        _bit_equal(ex.jitted()(feeds), ex.run(feeds))
    assert (ex.stats["plans"], ex.stats["plan_runs"]) == (2, 1)


@pytest.mark.parametrize("case", [_case_stream, _case_decode_batch,
                                  _case_audio_encoder, _case_speaker_encoder],
                         ids=["stream_twice", "decode_batch",
                              "audio_encoder", "speaker_encoder"])
def test_jitted_equals_run_bit_for_bit(case):
    case()


# ---------------------------------------------------- against the JAX jit
def test_jitted_decoder_matches_jax_jitted():
    """The MINI decoder's every output, one signature planned then run,
    and its vmap over 2 lanes, against the JAX executor's jitted() and
    jax.jit(jax.vmap(run))."""
    data, _ = tfx.build_decoder(tfx.MINI, seed=0)
    jex = JEx(jlite.read_onnx_graph(data))
    dec = _decoder(data)
    codes = _codes((2, 3, tfx.NB), 3)
    state = dec.create_state()
    feeds = _feeds(dec, codes[0], state)
    jfeeds = {k: jnp.asarray(_np(v)) for k, v in feeds.items()}
    want = jex.jitted()(jex.params, jfeeds)
    for _ in range(2):
        got = dec.ex.jitted()(feeds)
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k], what=k)
    bfeeds = {k: torch.stack([v, v]) for k, v in feeds.items()}
    bfeeds["audio_codes"] = torch.stack([dec._frames(c)[None]
                                         for c in codes])
    want = jax.jit(jax.vmap(jex.run, in_axes=(None, 0)))(
        jex.params, {k: jnp.asarray(_np(v)) for k, v in bfeeds.items()})
    for _ in range(2):
        got = dec.ex.jitted().vmap(bfeeds)
        for k in want:        # JAX's vmap broadcasts a HOST output
            g = got[k] if isinstance(got[k], torch.Tensor) else \
                np.broadcast_to(got[k], np.shape(want[k]))
            _same(g, want[k], what=k)


def test_jitted_encoders_match_jax():
    """Both encoder classes (through jitted) against the JAX classes
    (through jax.jit): codes exactly, the embedding within EMB_TOL."""
    edata, _ = tfx.build_encoder(ENC, seed=2)
    sdata, _ = tfx.build_speaker(tfx.SpkDims(), seed=4)
    wav = np.random.default_rng(21).standard_normal(16 * 11 + 5).astype(
        np.float32)
    mels = np.random.default_rng(22).standard_normal((37, 128)).astype(
        np.float32)
    enc = OnnxAudioEncoder(TEx(tlite.read_onnx_graph(edata), "cpu"))
    spk = OnnxSpeakerEncoder(TEx(tlite.read_onnx_graph(sdata), "cpu"))
    jcodes = JAE(JEx(jlite.read_onnx_graph(edata))).encode(wav)
    jemb = JSE(JEx(jlite.read_onnx_graph(sdata))).encode_mels(mels)
    for _ in range(2):
        np.testing.assert_array_equal(enc.encode(wav),
                                      jcodes.astype(np.int64))
        np.testing.assert_allclose(spk.encode_mels(mels), jemb, atol=EMB_TOL)
    assert enc.ex.stats["plans"] == spk.ex.stats["plans"] == 1
    assert enc.ex.stats["walks"] == spk.ex.stats["walks"] == 1


# ---------------------------------------------------------- the plan cache
def test_a_plan_run_skips_the_host_nodes_and_copies(monkeypatch):
    """A second call builds no plan; its run calls no handler of a node
    that made only HOST values (Shape here) and copies nothing from the
    host."""
    dec = _decoder()
    feeds = _feeds(dec, _codes((2, tfx.NB), 4), dec.create_state())
    fn = dec.ex.jitted()
    want = fn(feeds)
    shapes, copies = [], []
    real_shape, real_from_numpy = TEx._op_Shape, torch.from_numpy
    monkeypatch.setattr(TEx, "_op_Shape", lambda self, *a, **k:
                        shapes.append(1) or real_shape(self, *a, **k))
    monkeypatch.setattr(torch, "from_numpy", lambda a: copies.append(1)
                        or real_from_numpy(a))
    got = fn(feeds)
    assert shapes == [] and copies == []
    assert dec.ex.stats["plans"] == 1 and dec.ex.stats["walks"] == 1
    plan = fn._entries[next(iter(fn._entries))].plan
    assert 0 < len(plan.steps) < len(dec.ex.graph.nodes)
    _bit_equal(got, want)
    dec.ex.run(feeds)
    assert shapes and copies            # the eager walk does both


@pytest.mark.parametrize("change", ["frames", "dtype", "batch", "state"])
def test_a_changed_signature_builds_its_own_plan(change):
    """The first signature planned; a call that changes one feed's shape
    or dtype, the batch of a vmap, or the carried state's length builds a
    plan of its own, and each signature's calls equal run's on their own
    feeds (no stale plan is run)."""
    dec = _decoder()
    fn = dec.ex.jitted()
    codes = _codes((3, 4, tfx.NB), 5)
    base = _feeds(dec, codes[0, :2], dec.create_state())
    if change == "frames":
        other = _feeds(dec, codes[0, :3], dec.create_state())
    elif change == "dtype":
        other = dict(base, audio_codes=base["audio_codes"].int())
    elif change == "state":
        out = dec.ex.run(_feeds(dec, codes[1, :1], dec.create_state()))
        other = _feeds(dec, codes[0, :2], {k: out[_next_name(k)]
                                           for k in dec.state_names})
    if change == "batch":
        two = {k: torch.stack([v] * 2) for k, v in base.items()}
        three = {k: torch.stack([v] * 3) for k, v in base.items()}
        three["audio_codes"] = torch.stack([dec._frames(c[:2])[None]
                                            for c in codes])
        for _ in range(2):
            _bit_equal(fn.vmap(two), _eager_vmap(dec.ex, two))
            _bit_equal(fn.vmap(three), _eager_vmap(dec.ex, three))
    else:
        for _ in range(2):
            _bit_equal(fn(base), dec.ex.run(base))
            _bit_equal(fn(other), dec.ex.run(other))
    assert dec.ex.stats["plans"] == len(fn) == 2
    assert dec.ex.stats["plan_runs"] == 2


def test_the_bound_evicts_least_recently_used_first(monkeypatch):
    monkeypatch.setattr(onnx_exec, "MAX_SIGNATURES", 2)
    dec = _decoder()
    fn = dec.ex.jitted()
    feeds = [_feeds(dec, _codes((n, tfx.NB), n), dec.create_state())
             for n in (1, 2, 3)]
    fn(feeds[0]), fn(feeds[1]), fn(feeds[0])     # 1 is now the oldest
    fn(feeds[2])                                 # evicts 1
    assert len(fn) == 2 and dec.ex.stats["plans"] == 3
    _bit_equal(fn(feeds[0]), dec.ex.run(feeds[0]))
    assert dec.ex.stats["plans"] == 3            # 0 was kept
    _bit_equal(fn(feeds[1]), dec.ex.run(feeds[1]))
    assert dec.ex.stats["plans"] == 4 and len(fn) == 2


def test_host_outputs_come_back_as_run_gives_them():
    """valid_samples, folded on the host from the waveform's shape (and,
    in a second graph, less 3 by a host Sub): numpy as run gives it, a
    copy the caller may write, unbatched under vmap."""
    data, _ = tfx.build_decoder(tfx.MINI)
    g = tlite.read_onnx_graph(data)
    g.nodes[-1] = tlite.OnnxNode("Shape", ["final_wav"], ["n_all"])
    g.nodes.append(tlite.OnnxNode("Sub", ["n_all", "three"],
                                  ["valid_samples"]))
    g.initializers["three"] = np.array([3], np.int64)
    for dec in (_decoder(), _decoder(tlite.write_onnx(g))):
        feeds = _feeds(dec, _codes((3, tfx.NB), 6), dec.create_state())
        want = dec.ex.run(feeds)["valid_samples"]
        fn = dec.ex.jitted()
        for _ in range(2):
            got = fn(feeds)["valid_samples"]
            assert isinstance(got, np.ndarray)
            np.testing.assert_array_equal(got, want)
            got[...] = -1
        two = {k: torch.stack([v] * 2) for k, v in feeds.items()}
        for _ in range(2):
            np.testing.assert_array_equal(fn.vmap(two)["valid_samples"],
                                          want)
        wav, _ = dec.decode(_codes((3, tfx.NB), 6), dec.create_state())
        assert wav.shape == (int(want[0]),)
