"""The mesh, the launch glue and the serving classes on a mesh
(qwen3_tts_tpu_torch/parallel/mesh.py, distributed.py; serve/batch.py and
serve/continuous.py with `mesh=`) on the CPU.

- In this process: the single-process mesh and make_mesh's refusal of a
  mesh without its ranks; init_distributed as a no-op without torchrun's
  environment (the JAX test_distributed_single_process_degrades), its
  refusal of half of it and of nccl without a GPU; make_serving_mesh's refusal of a model axis that
  does not divide the ranks; local_lane_slice and local_batch by data
  index; shard_params on plain, int8 and int4 (output-major: blocks of the
  LAST axis) weights, whose blocks put back together give the whole, a
  one-group int4 scale kept whole, and its refusals (packed kernel
  layouts, a block that cuts a scale group or is not a multiple of 8).
- In two ranks joined by gloo (tests/torch_parallel_workers.py; one spawn
  per mesh layout): on a 2 x 1 mesh, make_mesh's and make_serving_mesh's
  refusals in a group (a world that does not match, model_parallel not
  dividing the world or above one host's ranks) and the lane slices;
  BatchSynthesizer and ContinuousBatcher on the 2 x 1 mesh, greedy and
  sampled, give every rank the same frames, EOS flags and codes as the
  unsharded classes at the same seed, audio within WAV_ATOL (the JAX
  test_dp_sharded_generation and
  test_continuous_batching_dp_mesh_matches_unsharded: sharding is a
  placement decision, not a numerics one); on a 1 x 2 mesh the same
  classes on the row-parallel schedule, greedy, the same frames and codes,
  audio within WAV_ATOL.
"""

import numpy as np
import pytest
import torch

from qwen3_tts_tpu_torch.core.config import EngineConfig
from qwen3_tts_tpu_torch.ops import quant
from qwen3_tts_tpu_torch.parallel import distributed
from qwen3_tts_tpu_torch.parallel import mesh as mesh_lib
from qwen3_tts_tpu_torch.parallel.mesh import Mesh

import torch_parallel_workers as W

WAV_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread, as in the ranks (each sets its own)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------- one process
def test_single_process_mesh():
    m = mesh_lib.make_mesh(1, 1, device="cpu")
    assert (m.size, m.rank, m.shape) == (1, 0, {"data": 1, "model": 1})
    assert m.model_group is None and m.data_group is None
    x = torch.ones(3)
    assert m.reduce_model(x) is x and m.all_reduces == 0
    assert m.all_done(torch.tensor([True, True]))
    assert not m.all_done(torch.tensor([True, False]))
    assert m.gather_data("x") == ["x"]
    with pytest.raises(ValueError, match="needs 2 ranks"):
        mesh_lib.make_mesh(2, 1, device="cpu")
    with pytest.raises(ValueError, match="outside the mesh"):
        Mesh(2, 1, 2, 0, "cpu")


def test_distributed_single_process_degrades(monkeypatch):
    for k in distributed.LAUNCH_ENV + ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.init_distributed() is False
    mesh = distributed.make_serving_mesh(1, device="cpu")
    assert mesh.size == 1
    with pytest.raises(ValueError, match="divisible"):
        distributed.make_serving_mesh(2, device="cpu")
    assert distributed.local_lane_slice(mesh, 16) == slice(0, 16)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        distributed.init_distributed()
    for k, v in (("MASTER_ADDR", "localhost"), ("MASTER_PORT", "1"),
                 ("RANK", "0")):
        monkeypatch.setenv(k, v)
    if not torch.cuda.is_available():     # no CPU fallback for nccl
        with pytest.raises(RuntimeError, match="nccl needs a CUDA device"):
            distributed.init_distributed("nccl")


def test_lane_slices_follow_the_data_index():
    # rank = data_index * n_model + model_index: both ranks of data index
    # 1 feed lanes 4-7 of 8
    for model_index in (0, 1):
        m = Mesh(2, 2, 1, model_index, "cpu")
        assert m.rank == 2 + model_index
        assert distributed.local_lane_slice(m, 8) == slice(4, 8)
    assert mesh_lib.local_batch(Mesh(4, 1, 0, 0, "cpu"), 8) == slice(0, 2)
    with pytest.raises(ValueError, match="split"):
        mesh_lib.local_batch(Mesh(3, 1, 0, 0, "cpu"), 8)
    cfg = EngineConfig().talker
    assert mesh_lib.kv_cache_spec(cfg, Mesh(2, 2, 0, 1, "cpu"), 8, 1024) == \
        (28, 4, 4, 1024, 128)


def _layers(kind, k=256, n=96):
    """Stacked [2, k, n] weights of `kind` (int4: 2 groups of 128 rows)."""
    w = torch.randn(2, k, n, generator=torch.Generator().manual_seed(0))
    return {"plain": lambda: w, "int8": lambda: quant.quantize_weight(w),
            "int4": lambda: quant.quantize_weight_int4(w * 0.1)}[kind]()


def _whole(blocks, kind):
    """The blocks of n_model ranks put back together."""
    if kind == "plain":
        return torch.cat(blocks, dim=-2)
    if kind == "int8":
        assert all(b["s"] is blocks[0]["s"] for b in blocks)
        return {"q": torch.cat([b["q"] for b in blocks], dim=-2),
                "s": blocks[0]["s"]}
    s = [b["s"] for b in blocks]
    return {"q4": torch.cat([b["q4"] for b in blocks], dim=-1),
            "s": s[0] if all(x is s[0] for x in s) else torch.cat(s, -1)}


@pytest.mark.parametrize("kind", ["plain", "int8", "int4"])
def test_shard_params_blocks_make_the_whole(kind):
    """Blocks of the contraction axis (int4: the last axis of q4 and s),
    put back together, equal the whole; each block's product with its
    slice of x sums to the whole product (int4 unpacked per block)."""
    w = _layers(kind)
    params = {"layers": {"wqkv": w, "ln1": torch.ones(2, 256)},
              "final_norm": torch.ones(256), "codec_head": torch.ones(4, 256)}
    blocks = [mesh_lib.shard_params(params, Mesh(1, 2, 0, i, "cpu"),
                                    mesh_lib.talker_param_specs())
              for i in range(2)]
    for b in blocks:          # replicated leaves are the same tensors
        assert b["final_norm"] is params["final_norm"]
        assert b["layers"]["ln1"] is params["layers"]["ln1"]
    got = _whole([b["layers"]["wqkv"] for b in blocks], kind)
    if kind == "plain":
        assert torch.equal(got, w)
    else:
        for key in w:
            assert torch.equal(got[key], w[key]), key
    x = torch.randn(3, 256, generator=torch.Generator().manual_seed(1))
    whole = quant.matmul(x, quant.take(w, 0))
    parts = sum(quant.matmul(x[:, i * 128:(i + 1) * 128],
                             quant.take(b["layers"]["wqkv"], 0))
                for i, b in enumerate(blocks))
    torch.testing.assert_close(parts, whole, atol=1e-4, rtol=1e-4)


def test_shard_params_int4_scales_and_refusals():
    m = Mesh(1, 2, 0, 1, "cpu")
    specs = mesh_lib.talker_param_specs()
    # K = 64: one group of 64 rows, so each block of 32 keeps the scale
    one = quant.quantize_weight_int4(torch.randn(2, 64, 16))
    assert one["s"].shape[-1] == 1
    got = mesh_lib.shard_params({"layers": {"wo": one}}, m, specs)
    assert got["layers"]["wo"]["s"] is one["s"]
    assert torch.equal(got["layers"]["wo"]["q4"], one["q4"][..., 16:])
    # K = 384: 3 groups of 128 over 2 ranks: a block cuts a group
    three = quant.quantize_weight_int4(torch.randn(2, 384, 16))
    with pytest.raises(ValueError, match="cuts a scale group"):
        mesh_lib.shard_params({"layers": {"wo": three}}, m, specs)
    # K = 8 over 2 ranks: blocks of 4 rows split a packed word
    eight = quant.quantize_weight_int4(torch.randn(2, 8, 16), group=8)
    with pytest.raises(ValueError, match="multiple of 8"):
        mesh_lib.shard_params({"layers": {"wo": eight}}, m, specs)
    with pytest.raises(ValueError, match="not a multiple of n_model"):
        mesh_lib.shard_params({"layers": {"wo": torch.randn(2, 5, 4)}}, m,
                              specs)
    with pytest.raises(ValueError, match="packed kernel layouts"):
        mesh_lib.shard_params({"layers": {}, "fused_w4a8": {}}, m, specs)
    stripped = mesh_lib.strip_packs({"layers": 1, "chunk": 2,
                                     "fused_int8": 3, "talker_step_mode": 4})
    assert stripped == {"layers": 1}


# ----------------------------------------------------- ranks of a mesh
@pytest.fixture(scope="module")
def unsharded(tmp_path_factory):
    eng = W.tiny_engine(tmp_path_factory.mktemp("unsharded"))
    return {t: W.serve_classes(eng, None, t) for t in (0.0, 0.7)}


def _ranks(tmp_path_factory, n_data, n_model, temperatures):
    root = tmp_path_factory.mktemp(f"mesh{n_data}x{n_model}")
    W.run_ranks(W.classes_on_mesh, n_data * n_model, root, n_data, n_model,
                temperatures)
    return [W.load(root / f"classes_{r}.pkl")
            for r in range(n_data * n_model)]


@pytest.fixture(scope="module")
def dp_ranks(tmp_path_factory):
    return _ranks(tmp_path_factory, 2, 1, (0.0, 0.7))


@pytest.fixture(scope="module")
def tp_ranks(tmp_path_factory):
    return _ranks(tmp_path_factory, 1, 2, (0.0,))


def test_mesh_refusals_in_a_group(dp_ranks):
    for r, got in enumerate(dp_ranks):
        ref = got["refusals"]
        assert "mesh 1x1 needs 1 ranks" in ref["make_mesh_1x1"]
        assert "has 2" in ref["make_mesh_2x2"]
        assert "divisible by model_parallel=3" in ref["serving_mp3"]
        assert "exceeds the 1 ranks of one host" in \
            ref["serving_mp2_one_a_host"]
        assert got["mesh"] == (2, 1, r, 0)
        assert got["lanes"] == slice(2 * r, 2 * r + 2)
        assert got["init_again"] is True
        assert got["all_reduces"] == 0        # no collective on the math


def _same(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g[:2] == w[:2], f"{what} request {i}: frames, eos"
        assert g[0] > 0
        np.testing.assert_array_equal(g[2], w[2], f"{what} request {i}")
        np.testing.assert_allclose(g[3], w[3], atol=WAV_ATOL,
                                   err_msg=f"{what} request {i}")


@pytest.mark.parametrize("scheduler", ["wave", "queue"])
@pytest.mark.parametrize("temperature", [0.0, 0.7], ids=["greedy",
                                                         "sampled"])
def test_data_parallel_classes_match_unsharded(dp_ranks, unsharded,
                                               scheduler, temperature):
    """BatchSynthesizer (wave) and ContinuousBatcher (queue) on the 2 x 1
    mesh: each rank returns every request, equal to the unsharded class's
    at the same seed."""
    for r, got in enumerate(dp_ranks):
        _same(got[temperature][scheduler], unsharded[temperature][scheduler],
              f"rank {r} {scheduler} t={temperature}")


@pytest.mark.parametrize("scheduler", ["wave", "queue"])
def test_tensor_parallel_classes_match_unsharded(tp_ranks, unsharded,
                                                 scheduler):
    """The same classes on the 1 x 2 mesh (the row-parallel schedule),
    greedy: both ranks return the unsharded class's frames and codes."""
    for r, got in enumerate(tp_ranks):
        _same(got[0.0][scheduler], unsharded[0.0][scheduler],
              f"rank {r} {scheduler}")
        assert got["all_reduces"] > 0
