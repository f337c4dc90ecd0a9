"""The port's row-parallel schedule (qwen3_tts_tpu_torch/parallel/tp.py) on
the CPU, against the JAX package's shard_map schedule
(qwen3_tts_tpu/parallel/tp.py).

The JAX functions run here on the 8-virtual-device mesh 4 x 2 of
tests/conftest.py (skipped as tests/test_tp.py is where it is missing), at
`EngineConfig.tiny()` (f32) on the JAX test's params and on inputs made
from numpy seeds.  The port's functions run in spawned ranks joined by
gloo (tests/torch_parallel_workers.py: torch and the port only) on meshes
1 x 2 and 2 x 2, on the same params carried by io/from_jax.tree_to_torch,
each rank on its data block of the inputs; one spawn per mesh layout.
Each of the six functions is held on each layout: floats within TP_TOL
(tests/test_tp.py's 3e-4, absolute and relative: f32 sums in another
order), codes, valid masks (the budget-masked valid of tp_gen_bulk
included), EOS flags, positions and cursors exactly.  The ranks of a
model group agree bit for bit (their all-reduced logits are the same
buffers, so they sample alike).

Quantized TP has no JAX counterpart (the JAX tp.py takes plain weights;
its quantized TP is the GSPMD path), so int8, int8 with the a8w8 prefill
and int4 TP on the 1 x 2 mesh are held against the port's own unsharded
forward on the same weights: the same products summed in two parts (f32),
the a8 row scale taken from the whole row on both sides.  int8 and a8
within QUANT_TOL; int4 within INT4_TOL, since matmul_int4 takes its input
in bf16: a partial sum in another f32 order moves an activation across a
bf16 rounding now and then (2^-9 relative), which later layers carry.  On
this model the unsharded int4 prefill's logits (max |logit| 4.2) move by
1.2e-2 under a 1e-7 relative noise on its input; TP moved them by at most
8.4e-3.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qwen3_tts_tpu.core.config import EngineConfig as JC
from qwen3_tts_tpu.io.assets import Assets
from qwen3_tts_tpu.models import predictor as jpred
from qwen3_tts_tpu.models import talker as jtalk
from qwen3_tts_tpu.parallel import mesh as jmesh
from qwen3_tts_tpu.parallel import tp as jtp
from qwen3_tts_tpu.runtime.generate import SamplerParams as JSP

import torch_parallel_workers as W

TP_TOL = 3e-4
QUANT_TOL = 3e-4
INT4_TOL = 2e-2
LAYOUTS = ((1, 2), (2, 2))
FUNCTIONS = ("prefill", "step", "predict", "frames", "bulk", "refill")
B, S, CAP, PCAP = 4, 16, 32, 16
HKV = JC.tiny().talker.n_kv_heads
# rows of every codebook table: above the 2160 codec logits, so that any
# sampled code 0 indexes a row
CODEC_ROWS = 2176


def _jit(fn, cfg, mesh, static=()):
    import functools
    return jax.jit(functools.partial(fn, cfg, mesh), static_argnames=static)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX tp_* results on the 4 x 2 mesh, and the inputs written for
    the port's ranks (root/tp_inputs.pkl)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    root = tmp_path_factory.mktemp("tp")
    mesh = jmesh.make_mesh(4, 2)
    cfg = JC.tiny()
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    talker = jtalk.init_talker_params(cfg.talker, k1)
    pred = jpred.init_predictor_params(cfg.predictor, k2)
    pack = Assets.random_init(jax.random.PRNGKey(8), text_rows=64,
                              codec_rows=CODEC_ROWS).pack()
    rng = np.random.default_rng(0)
    f32 = lambda *shape: (rng.standard_normal(shape) * 0.3).astype(  # noqa
        np.float32)
    a = dict(embeds=f32(B, S, 2048),
             lengths=np.asarray([16, 12, 9, 16], np.int32),
             embeds_step=f32(B, S, 2048), emb_step=f32(B, 2048),
             h1024=f32(B, 1024), code0=np.asarray([1, 5, 9, 3], np.int32),
             embeds_srv=f32(B, S, 2048),
             done0=np.asarray([False, True, False, False]),
             budgets=np.asarray([3, 4, 1, 4], np.int32),
             refill_embeds=f32(2, S, 2048),
             refill_lengths=np.asarray([S, S - 3], np.int32),
             refill_lanes=np.asarray([1, 3], np.int32),
             emb_refill_step=f32(B, 2048))
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    W.save(root / "tp_inputs.pkl", dict(
        talker=np_(talker), predictor=np_(pred), arrays=a, s=S, cap=CAP,
        pcap=PCAP))
    W.save_arrays(root, "pack", np_(pack))

    st = jmesh.place_params(talker, mesh, jmesh.talker_param_specs())
    sp = jmesh.place_params(pred, mesh, jmesh.predictor_param_specs())
    spk = jmesh.place_params(pack, mesh, jmesh.assets_pack_specs())
    j = {k: jnp.asarray(v) for k, v in a.items()}
    greedy = JSP(temperature=jnp.float32(0.0), top_k=jnp.int32(1),
                 top_p=jnp.float32(1.0))
    key = jax.random.PRNGKey(11)
    full = jnp.full((B,), S, jnp.int32)
    prefill = _jit(jtp.tp_talker_prefill, cfg, mesh, ("capacity",))
    step = _jit(jtp.tp_talker_step, cfg, mesh, ("prompt_cap",))
    frames = _jit(jtp.tp_gen_frames, cfg, mesh, ("n_frames", "prompt_cap"))
    out = {}
    lg, hd, k, _ = prefill(st, j["embeds"], j["lengths"], capacity=CAP)
    out["prefill"] = dict(logits=lg, hidden=hd, k=k)
    _, _, k2, v2 = prefill(st, j["embeds_step"], full, capacity=CAP)
    lg, hd, _, _ = step(st, j["emb_step"], full, k2, v2, full,
                        jnp.int32(PCAP), prompt_cap=PCAP)
    out["step"] = dict(logits=lg, hidden=hd)
    out["predict"] = dict(codes=_jit(jtp.tp_predict_frame, cfg, mesh)(
        sp, j["h1024"], j["code0"], spk["codec_tables_1024"]))
    srv = prefill(st, j["embeds_srv"], full, capacity=CAP)
    ca, va, carry = frames(st, sp, spk, *srv, full, full, jnp.int32(S), key,
                           greedy, n_frames=2, prompt_cap=S)
    cb, vb, _ = frames(st, sp, spk, *carry, full, full + 2, jnp.int32(S + 2),
                       key, greedy, n_frames=2, prompt_cap=S)
    out["frames"] = dict(codes=jnp.concatenate([ca, cb], 1),
                         valid=jnp.concatenate([va, vb], 1))
    bulk = _jit(jtp.tp_gen_bulk, cfg, mesh,
                ("max_frames", "chunk", "prompt_cap"))
    codes, valid, saw_eos, bcarry = bulk(
        st, sp, spk, *srv, full, full, jnp.int32(S), j["done0"], key, greedy,
        j["budgets"], max_frames=4, chunk=2, prompt_cap=S)
    out["bulk"] = dict(codes=codes, valid=valid, saw_eos=saw_eos,
                       done=bcarry[6])
    # the refill: from two frames of the serving state (carry), lanes 1, 3
    refill = _jit(jtp.tp_prefill_lanes, cfg, mesh)(
        st, j["refill_embeds"], j["refill_lengths"], j["refill_lanes"],
        *carry, full, full + 2, jnp.full((B,), S + 2, jnp.int32),
        jnp.zeros((B,), bool))
    lg3, _, k3, v3, lens3, pos3, widx3, _ = refill
    step_lg, _, _, _ = step(st, j["emb_refill_step"], pos3, k3, v3, lens3,
                            widx3, prompt_cap=S)
    out["refill"] = dict(logits=lg3, k=k3, pos=pos3, widx=widx3,
                         lengths=lens3, step_logits=step_lg)
    return root, {f: {k: np.asarray(v) for k, v in d.items()}
                  for f, d in out.items()}


def _spawn(root, n_data, n_model):
    W.run_ranks(W.tp_ranks, n_data * n_model, root, n_data, n_model)
    return [W.load(root / f"tp_{n_data}x{n_model}_{r}.pkl")
            for r in range(n_data * n_model)]


@pytest.fixture(scope="module")
def ranks(jax_side):
    root, _ = jax_side
    return {layout: _spawn(root, *layout) for layout in LAYOUTS}


def _close(got, want, what):
    np.testing.assert_allclose(got, want, atol=TP_TOL, rtol=TP_TOL,
                               err_msg=what)


@pytest.mark.parametrize("fn", FUNCTIONS)
@pytest.mark.parametrize("layout", LAYOUTS, ids=["1x2", "2x2"])
def test_tp_matches_jax(jax_side, ranks, layout, fn):
    """Rank r's block of each output against the JAX function's rows (and
    kv heads) of that block."""
    _, want = jax_side
    n_model = layout[1]
    hk = HKV // n_model
    for r, got in enumerate(ranks[layout]):
        sl, m = got["lanes"], r % n_model
        g, w = got[fn], {k: v[sl] if v.ndim and k != "k" else v
                         for k, v in want[fn].items()}
        if "k" in w:
            w["k"] = want[fn]["k"][:, sl, m * hk:(m + 1) * hk]
        what = f"{fn} rank {r} of {layout}"
        if fn in ("prefill", "step"):
            for k in w:
                _close(g[k], w[k], f"{what}: {k}")
        elif fn == "predict":
            np.testing.assert_array_equal(g["codes"], w["codes"], what)
        elif fn == "frames":
            np.testing.assert_array_equal(g["valid"], w["valid"], what)
            np.testing.assert_array_equal(g["codes"], w["codes"], what)
        elif fn == "bulk":
            for k in ("valid", "saw_eos", "done"):
                np.testing.assert_array_equal(g[k], w[k], f"{what}: {k}")
            np.testing.assert_array_equal(g["codes"][g["valid"]],
                                          w["codes"][w["valid"]], what)
            # budgets [3, 4, 1, 4], lane 1 done at entry
            assert g["valid"].sum(1).tolist() == \
                [3, 0, 1, 4][sl.start:sl.stop], what
        else:
            for k in ("pos", "widx", "lengths"):
                np.testing.assert_array_equal(g[k], w[k], f"{what}: {k}")
            for k in ("logits", "k", "step_logits"):
                _close(g[k], w[k], f"{what}: {k}")


@pytest.mark.parametrize("layout", LAYOUTS, ids=["1x2", "2x2"])
def test_model_group_ranks_agree(ranks, layout):
    """The ranks of a model group (one data index) give bit-equal logits,
    codes and flags: they all-reduce the same buffers, and a rank that
    decided otherwise would stop calling the others' all-reduces.  Each
    forward all-reduces 4 times a layer."""
    n_model = layout[1]
    got = ranks[layout]
    for d in range(layout[0]):
        group = got[d * n_model:(d + 1) * n_model]
        for other in group[1:]:
            for fn in FUNCTIONS:
                for k, v in group[0][fn].items():
                    if k != "k":
                        np.testing.assert_array_equal(
                            other[fn][k], v, f"{fn}.{k} data index {d}")
        assert len({g["all_reduces"] for g in group}) == 1
        assert group[0]["all_reduces"] % 4 == 0


@pytest.fixture(scope="module")
def quantized(jax_side):
    root, _ = jax_side
    return [W.load(root / f"tpq_{r}.pkl") for r in range(2)]


@pytest.mark.parametrize("kind", ["int8", "a8", "int4"])
def test_tp_quantized_matches_unsharded(ranks, quantized, kind):
    """int8, int8 with the a8w8 prefill, and int4 (output-major packing,
    its K blocks cut on the last axis) row-parallel on the 1 x 2 mesh:
    prefill logits, hidden and this rank's kv heads, then one step's logits
    and hidden, against models/talker on the unsharded weights."""
    for r, got in enumerate(quantized):
        tp_out, ref = got[kind]
        tol = INT4_TOL if kind == "int4" else QUANT_TOL
        for k in ref:
            np.testing.assert_allclose(tp_out[k], ref[k], atol=tol,
                                       rtol=tol,
                                       err_msg=f"{kind} rank {r}: {k}")
