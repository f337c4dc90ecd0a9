"""The port's llama.cpp parity harness (qwen3_tts_tpu_torch/io/
llama_parity.py) against the JAX package's: make_inputs equal, the port's
run_our_talker on the CPU against the JAX one on the same TalkerConfig.tiny()
weights (both f32: every entry within rel 1e-4 of the JAX side, top-1
equal), the harness's self-compare exact, a reversed wqkv caught (rel >
0.2), and compare_talker on a tiny talker GGUF passing the JAX rule
(rel <= 5e-2, top-1 >= 0.99) against a dump of the JAX run_our_talker on
the same file.  Nothing here needs llama.cpp."""

import numpy as np
import pytest
import torch

from qwen3_tts_tpu.core.config import TalkerConfig as JTC
from qwen3_tts_tpu.io import llama_parity as jlp
from qwen3_tts_tpu_torch.core.config import TalkerConfig
from qwen3_tts_tpu_torch.io import llama_parity as lp
from qwen3_tts_tpu_torch.io.from_jax import tree_to_torch

torch.set_num_threads(1)
F32_REL = 1e-4


@pytest.fixture(scope="module")
def tiny_pair():
    import jax
    from qwen3_tts_tpu.models import talker as jtalker
    jparams = jtalker.init_talker_params(JTC.tiny(), jax.random.PRNGKey(0))
    tparams = tree_to_torch(jax.tree_util.tree_map(np.asarray, jparams))
    return jparams, tparams


def test_make_inputs_equal_to_jax(tmp_path):
    a = lp.make_inputs(tmp_path / "a.npz", d_model=32, seed=5)
    want = jlp.make_inputs(None, d_model=32, seed=5)
    full = lp.make_inputs(None)
    jfull = jlp.make_inputs(None)
    for got, ref in ((a, want), (full, jfull)):
        assert sorted(got) == sorted(ref)
        for key in ref:
            np.testing.assert_array_equal(got[key], ref[key])
    assert full["embeds"].shape == (lp.PROMPT_ROWS, 2048)
    loaded = dict(np.load(tmp_path / "a.npz"))
    np.testing.assert_array_equal(loaded["step_embeds"], a["step_embeds"])


def test_run_our_talker_matches_jax(tiny_pair):
    jparams, tparams = tiny_pair
    inputs = lp.make_inputs(None, d_model=2048, seed=1, rows=12, steps=3)
    want = jlp.run_our_talker(JTC.tiny(), jparams, inputs)
    got = lp.run_our_talker(TalkerConfig.tiny(), tparams, inputs, "cpu")
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == want[key].shape and got[key].dtype == \
            np.float32
    stats = lp.compare_dumps(got, want)
    for key, val in stats.items():
        if key.endswith("_rel"):
            assert val <= F32_REL, (key, stats)
        if key.endswith("_top1_match"):
            assert val == 1.0, (key, stats)
    assert lp.top1_misses(got, want) == []


def test_harness_self_compare_and_corruption(tiny_pair):
    _, tparams = tiny_pair
    cfg = TalkerConfig.tiny()
    inputs = lp.make_inputs(None, d_model=2048, seed=2, rows=12, steps=3)
    good = lp.run_our_talker(cfg, tparams, inputs, "cpu")
    stats = lp.compare_dumps(good, good)
    assert stats["prefill_logits_max_abs"] == 0.0
    assert stats["step_logits_top1_match"] == 1.0
    bad_params = dict(tparams, layers=dict(tparams["layers"]))
    # shape-preserving import bug: rows reversed (what a wrong transpose
    # convention does to a square matrix)
    bad_params["layers"]["wqkv"] = tparams["layers"]["wqkv"].flip(1)
    bad = lp.run_our_talker(cfg, bad_params, inputs, "cpu")
    assert lp.compare_dumps(good, bad)["prefill_logits_rel"] > 0.2


def _tiny_talker_gguf(path, seed=0, vocab=2304):
    """A talker GGUF at TalkerConfig.tiny()'s dims under llama.cpp's
    tensor names (F32), from a seed."""
    from qwen3_tts_tpu_torch.io.gguf import write_gguf
    c = TalkerConfig.tiny()
    rng = np.random.default_rng(seed)
    d, f, dq, dkv = (c.d_model, c.d_ff, c.n_heads * c.head_dim,
                     c.n_kv_heads * c.head_dim)

    def w(*shape, fan):
        return (rng.standard_normal(shape) * fan ** -0.5).astype(np.float32)
    t = {}
    for i in range(c.n_layers):
        p = f"blk.{i}."
        t.update({
            p + "attn_norm.weight": np.ones(d, np.float32),
            p + "ffn_norm.weight": np.ones(d, np.float32),
            p + "attn_q.weight": w(dq, d, fan=d),
            p + "attn_k.weight": w(dkv, d, fan=d),
            p + "attn_v.weight": w(dkv, d, fan=d),
            p + "attn_output.weight": w(d, dq, fan=dq),
            p + "attn_q_norm.weight": np.ones(c.head_dim, np.float32),
            p + "attn_k_norm.weight": np.ones(c.head_dim, np.float32),
            p + "ffn_gate.weight": w(f, d, fan=d),
            p + "ffn_up.weight": w(f, d, fan=d),
            p + "ffn_down.weight": w(d, f, fan=f)})
    t["output_norm.weight"] = np.ones(d, np.float32)
    t["output.weight"] = w(vocab, d, fan=d)
    meta = {"general.architecture": "qwen3",
            "qwen3.block_count": c.n_layers,
            "qwen3.attention.head_count": c.n_heads,
            "qwen3.attention.head_count_kv": c.n_kv_heads,
            "qwen3.embedding_length": d,
            "qwen3.feed_forward_length": f,
            "qwen3.attention.key_length": c.head_dim,
            "qwen3.rope.freq_base": float(c.rope_theta),
            "qwen3.rope.mrope_section": list(c.mrope_sections[:3])}
    write_gguf(path, t, meta)
    return path


def test_compare_talker_on_a_gguf_against_a_jax_dump(tmp_path):
    """compare_talker reads the GGUF with the port's loader (TalkerConfig()
    as the JAX one: bf16 weights) and runs on the CPU; the "dump" is the
    JAX run_our_talker on the JAX loader's read of the same file."""
    from qwen3_tts_tpu.io import weights as jweights
    gguf = _tiny_talker_gguf(tmp_path / "talker.gguf")
    inputs = tmp_path / "inputs.npz"
    data = lp.make_inputs(inputs, d_model=2048, seed=3, rows=16, steps=4)
    jcfg, jparams = jweights.load_talker_gguf(gguf, JTC())
    assert (jcfg.n_layers, jcfg.head_dim, jcfg.dtype) == (2, 16, "bfloat16")
    dump = tmp_path / "dump.npz"
    np.savez(dump, **jlp.run_our_talker(jcfg, jparams, data))
    stats = lp.compare_talker(gguf, inputs, dump, device="cpu")
    assert max(v for k, v in stats.items() if k.endswith("_rel")) <= 5e-2
    assert min(v for k, v in stats.items()
               if k.endswith("top1_match")) >= 0.99
    # the same rule fails a corrupted dump, naming the stats
    bad = dict(np.load(dump))
    bad["step_logits"] = bad["step_logits"][:, ::-1].copy()
    np.savez(tmp_path / "bad.npz", **bad)
    with pytest.raises(AssertionError, match="parity vs llama.cpp FAILED"):
        lp.compare_talker(gguf, inputs, tmp_path / "bad.npz", device="cpu")


def test_top1_tie_excuse():
    """tie_tol excuses a top-1 miss only where both sides' picks lie within
    it of each other (over max |logit|)."""
    base = np.zeros((2, 8), np.float32)
    base[:, 0] = 10.0
    base[1, 3] = 10.0 - 1e-3            # ours: 0 by a hair
    near = base.copy()
    near[1, 3] = 10.0 + 1e-3            # flips row 1 by a hair
    far = base.copy()
    far[1, 3] = 12.0                    # flips row 1 by 0.2 of max
    ours = {"prefill_logits": base[0], "prefill_hidden": base[0],
            "step_logits": base, "step_hidden": base}
    for theirs, n_excused in ((near, 1), (far, 0)):
        d = dict(ours, step_logits=theirs)
        (miss,) = lp.top1_misses(ours, d)
        assert miss[:4] == ("step_logits", 1, 0, 3)
        excused = [m for m in [miss] if max(m[4], m[5]) <= 0.05]
        assert len(excused) == n_excused
