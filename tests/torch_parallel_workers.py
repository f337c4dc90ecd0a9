"""Ranks of a torch.distributed mesh for the CPU tests of
qwen3_tts_tpu_torch/parallel (tests/test_torch_parallel.py,
tests/test_torch_tp.py).  It imports torch, numpy and the port only, so
that a spawned rank never imports jax.

`run_ranks(target, world, root, *args)` starts `world` processes with the
spawn method, joins them by gloo through a file:// store under `root` (no
port, so parallel test workers cannot collide), runs target(rank, world,
root, *args) in each, and raises if any rank raises, exits non-zero or
outlives the timeout (a rank that stops calling a collective would leave
the others waiting).  Each target writes its outputs under `root` for the
test process to hold against its references.
"""

from __future__ import annotations

import os
import pickle
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT = 240


def _entry(rank, world, store, target, root, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        target(rank, world, Path(root), *args)
    finally:
        dist.destroy_process_group()


def run_ranks(target, world: int, root: Path, *args,
              timeout: float = TIMEOUT) -> None:
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    store = root / f"store_{time.monotonic_ns()}"
    ctx = torch.multiprocessing.start_processes(
        _entry, args=(world, str(store), target, str(root), args),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(10)


def save(path: Path, obj) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def load(path: Path):
    with open(path, "rb") as f:
        return pickle.load(f)


def save_arrays(root: Path, name: str, arrays) -> None:
    """Large arrays as .npy files, which each rank maps (load_arrays)
    instead of reading its own copy."""
    for k, v in arrays.items():
        np.save(root / f"{name}_{k}.npy", np.asarray(v))


def load_arrays(root: Path, name: str, keys):
    """{key: tensor} on copy-on-write maps of save_arrays' files."""
    return {k: torch.from_numpy(np.load(root / f"{name}_{k}.npy",
                                        mmap_mode="c")) for k in keys}


# ------------------------------------------------------------ the engines
def model_dir(root: Path) -> Path:
    """A model directory with the preset speaker vivian (tiny engines run
    on development weights from init_seed 0, the same in every process)."""
    from qwen3_tts_tpu_torch.io.voice_file import VoiceFile
    spk = root / "model" / "preset_speakers"
    if not spk.exists():
        spk.mkdir(parents=True, exist_ok=True)
        VoiceFile.new("", [], np.random.default_rng(0).standard_normal(2048)
                      .astype(np.float32) * 0.02).save(spk / "vivian.json")
    return root / "model"


def tiny_engine(root: Path):
    from qwen3_tts_tpu_torch.core.config import EngineConfig
    from qwen3_tts_tpu_torch.engine import TtsEngine
    return TtsEngine(model_dir=model_dir(root), config=EngineConfig.tiny(),
                     device="cpu")


WAVE_BUDGETS = (3, 8, None, 5, 7)        # two waves of 4, the second padded
QUEUE_BUDGETS = (6, 2, 8, 3, 5, 4)       # 6 requests on 4 lanes: refills


def serve_classes(eng, mesh, temperature: float):
    """The wave synthesizer and the continuous batcher on `eng` (and
    `mesh`, None for the unsharded classes) at one seed: {"wave",
    "queue"}: [(frames, eos, codes, audio)] per request."""
    from qwen3_tts_tpu_torch.core.config import SamplerConfig
    from qwen3_tts_tpu_torch.serve.batch import (BatchRequest,
                                                 BatchSynthesizer)
    from qwen3_tts_tpu_torch.serve.continuous import ContinuousBatcher
    eng.set_max_steps(8)
    voice = eng.get_speaker("vivian")
    out = {}
    eng.set_sampler_config(SamplerConfig(temperature=temperature, seed=5))
    res = BatchSynthesizer(eng, batch_size=4, mesh=mesh).synthesize(
        [BatchRequest(f"wave request {i}" + " more" * i, voice, max_frames=m)
         for i, m in enumerate(WAVE_BUDGETS)])
    out["wave"] = [(r.frames, r.eos, r.codes, r.audio.samples) for r in res]
    eng.set_sampler_config(SamplerConfig(temperature=temperature, seed=7))
    res = ContinuousBatcher(eng, batch_size=4, mesh=mesh,
                            max_frames_per_stream=8).run(
        [BatchRequest(f"queued request {i}" + " longer" * (i % 3), voice,
                      max_frames=m) for i, m in enumerate(QUEUE_BUDGETS)])
    out["queue"] = [(r.frames, r.eos, r.codes, r.audio.samples)
                    for r in res]
    return out


def classes_on_mesh(rank, world, root, n_data, n_model, temperatures):
    """The serving classes on an n_data x n_model mesh at `temperatures`;
    on a 2 x 1 mesh also make_mesh's and make_serving_mesh's refusals in a
    group and local_lane_slice.  Writes classes_<rank>.pkl."""
    from qwen3_tts_tpu_torch.parallel import distributed, mesh as mesh_lib
    out = {}
    if (n_data, n_model) == (2, 1):
        refusals = {}
        for name, fn in (("make_mesh_1x1", lambda: mesh_lib.make_mesh(
                              1, 1, device="cpu")),
                         ("make_mesh_2x2", lambda: mesh_lib.make_mesh(
                              2, 2, device="cpu")),
                         ("serving_mp3", lambda: distributed
                          .make_serving_mesh(3, device="cpu"))):
            try:
                fn()
            except ValueError as e:
                refusals[name] = str(e)
        os.environ["LOCAL_WORLD_SIZE"] = "1"        # one rank a host
        try:
            distributed.make_serving_mesh(2, device="cpu")
        except ValueError as e:
            refusals["serving_mp2_one_a_host"] = str(e)
        del os.environ["LOCAL_WORLD_SIZE"]
        out["refusals"] = refusals
        mesh = distributed.make_serving_mesh(1, device="cpu")
        out["mesh"] = (mesh.n_data, mesh.n_model, mesh.data_index,
                       mesh.model_index)
        out["lanes"] = distributed.local_lane_slice(mesh, 4)
        out["init_again"] = distributed.init_distributed()
    else:
        mesh = mesh_lib.make_mesh(n_data, n_model, device="cpu")
    eng = tiny_engine(root)
    for temperature in temperatures:
        out[temperature] = serve_classes(eng, mesh, temperature)
    out["all_reduces"] = mesh.all_reduces
    save(root / f"classes_{rank}.pkl", out)


# ------------------------------------------------- the tp_* functions
PACK_KEYS = ("codec_tables", "codec_tables_1024", "proj_w", "proj_b",
             "tts_pad")


def _greedy():
    from qwen3_tts_tpu_torch.runtime.generate import SamplerParams
    return SamplerParams(temperature=0.0, top_k=1, top_p=1.0)


def tp_functions(rank, world, root, n_data, n_model):
    """The six tp_* functions on an n_data x n_model mesh from the JAX
    test's params and inputs (root/tp_inputs.pkl, numpy), this rank's data
    block of every batch input.  Writes tp_<n_data>x<n_model>_<rank>.pkl."""
    from qwen3_tts_tpu_torch.core.config import EngineConfig
    from qwen3_tts_tpu_torch.io.from_jax import tree_to_torch
    from qwen3_tts_tpu_torch.parallel import mesh as mesh_lib
    from qwen3_tts_tpu_torch.parallel import tp
    inp = load(root / "tp_inputs.pkl")
    cfg = EngineConfig.tiny()
    mesh = mesh_lib.make_mesh(n_data, n_model, device="cpu")
    talker = mesh_lib.shard_params(tree_to_torch(inp["talker"]), mesh,
                                   mesh_lib.talker_param_specs())
    pred = mesh_lib.shard_params(tree_to_torch(inp["predictor"]), mesh,
                                 mesh_lib.predictor_param_specs())
    pack = load_arrays(root, "pack", PACK_KEYS)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in inp["arrays"].items()}
    b = t["embeds"].shape[0]
    sl = mesh_lib.local_batch(mesh, b)
    s, cap, pcap = inp["s"], inp["cap"], inp["pcap"]
    greedy = _greedy()
    gen = torch.Generator().manual_seed(0)
    out = {"lanes": sl}
    with torch.no_grad():
        lg, hd, k, v = tp.tp_talker_prefill(cfg, mesh, talker,
                                            t["embeds"][sl],
                                            t["lengths"][sl], cap)
        out["prefill"] = dict(logits=lg, hidden=hd, k=k)

        full = torch.full((b,), s, dtype=torch.int32)[sl]
        _, _, k2, v2 = tp.tp_talker_prefill(cfg, mesh, talker,
                                            t["embeds_step"][sl], full, cap)
        lg, hd, _, _ = tp.tp_talker_step(cfg, mesh, talker,
                                         t["emb_step"][sl], full, k2, v2,
                                         full, pcap, pcap)
        out["step"] = dict(logits=lg, hidden=hd)

        out["predict"] = dict(codes=tp.tp_predict_frame(
            cfg, mesh, pred, t["h1024"][sl], t["code0"][sl],
            pack["codec_tables_1024"]))

        # the serving state: a prefill of embeds_srv at full lengths
        lg0, hd0, k0, v0 = tp.tp_talker_prefill(cfg, mesh, talker,
                                                t["embeds_srv"][sl], full,
                                                cap)
        state = lambda: (lg0, hd0, k0.clone(), v0.clone())   # noqa: E731
        ca, va, (lga, hda, ka, vka) = tp.tp_gen_frames(
            cfg, mesh, talker, pred, pack, *state(), full, full, s, gen,
            greedy, 2, s)
        cb, vb, _ = tp.tp_gen_frames(cfg, mesh, talker, pred, pack, lga, hda,
                                     ka, vka, full, full + 2, s + 2, gen,
                                     greedy, 2, s)
        out["frames"] = dict(codes=torch.cat([ca, cb], 1),
                             valid=torch.cat([va, vb], 1))

        codes, valid, saw_eos, carry, n = tp.tp_gen_bulk(
            cfg, mesh, talker, pred, pack, *state(), full, full, s,
            t["done0"][sl], gen, greedy, t["budgets"][sl], max_frames=4,
            chunk=2, prompt_cap=s)
        out["bulk"] = dict(codes=codes, valid=valid, saw_eos=saw_eos,
                           done=carry[6], frames_run=n)

        # two frames, then a refill of global lanes t["refill_lanes"]
        _, _, (lg2, hd2, k2, v2) = tp.tp_gen_frames(
            cfg, mesh, talker, pred, pack, *state(), full, full, s, gen,
            greedy, 2, s)
        lanes = [int(x) for x in t["refill_lanes"]]
        mine = [i for i, x in enumerate(lanes) if sl.start <= x < sl.stop]
        widx = torch.full((sl.stop - sl.start,), s + 2, dtype=torch.int32)
        st = (lg2, hd2, k2, v2, full.clone(), full + 2, widx,
              torch.zeros(sl.stop - sl.start, dtype=torch.bool))
        if mine:
            st = tp.tp_prefill_lanes(
                cfg, mesh, talker, t["refill_embeds"][mine],
                t["refill_lengths"][mine],
                [lanes[i] - sl.start for i in mine], *st)
        lg3, hd3, k3, v3, lens3, pos3, widx3, done3 = st
        out_k3 = k3.clone()         # the step below writes k3 in place
        step_lg, _, _, _ = tp.tp_talker_step(
            cfg, mesh, talker, t["emb_refill_step"][sl], pos3, k3, v3, lens3,
            widx3, s)
        out["refill"] = dict(logits=lg3, k=out_k3, pos=pos3, widx=widx3,
                             lengths=lens3, step_logits=step_lg)
    out = {name: ({k: (v.numpy() if torch.is_tensor(v) else v)
                   for k, v in d.items()} if isinstance(d, dict) else d)
           for name, d in out.items()}
    out["all_reduces"] = mesh.all_reduces
    save(root / f"tp_{n_data}x{n_model}_{rank}.pkl", out)


def tp_ranks(rank, world, root, n_data, n_model):
    """tp_functions, and on a 1 x n mesh tp_quantized."""
    tp_functions(rank, world, root, n_data, n_model)
    if n_data == 1:
        tp_quantized(rank, world, root)


def tp_quantized(rank, world, root):
    """The row-parallel prefill and a decode step on int8 (a8 off and on)
    and int4 talker weights on a 1 x n mesh, beside the port's unsharded
    forward on the same weights and inputs (root/tp_inputs.pkl).  Writes
    tpq_<rank>.pkl: {kind: (tp outputs, unsharded outputs)}."""
    from qwen3_tts_tpu_torch.core.config import EngineConfig
    from qwen3_tts_tpu_torch.io.from_jax import tree_to_torch
    from qwen3_tts_tpu_torch.models import talker as talker_lib
    from qwen3_tts_tpu_torch.ops import quant
    from qwen3_tts_tpu_torch.parallel import mesh as mesh_lib
    from qwen3_tts_tpu_torch.parallel import tp
    inp = load(root / "tp_inputs.pkl")
    cfg = EngineConfig.tiny()
    mesh = mesh_lib.make_mesh(1, world, device="cpu")
    plain = tree_to_torch(inp["talker"])
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in inp["arrays"].items()}
    s, cap = inp["s"], inp["cap"]
    embeds, lengths = t["embeds"], t["lengths"]
    b = embeds.shape[0]
    out = {}
    for kind in ("int8", "a8", "int4"):
        layers = (quant.quantize_decoder_layers_int4(plain["layers"])
                  if kind == "int4"
                  else quant.quantize_decoder_layers(plain["layers"]))
        whole = dict(plain, layers=layers)
        local = mesh_lib.shard_params(whole, mesh,
                                      mesh_lib.talker_param_specs())
        a8 = kind == "a8"
        with torch.no_grad():
            lg, hd, k, v = tp.tp_talker_prefill(cfg, mesh, local, embeds,
                                                lengths, cap, a8=a8)
            pos = lengths.clone()
            slg, shd, _, _ = tp.tp_talker_step(cfg, mesh, local,
                                               t["emb_step"], pos, k, v,
                                               lengths, s, s)
            cache = talker_lib.init_talker_cache(cfg.talker, b, cap, "cpu")
            rlg, rhd, cache = talker_lib.talker_prefill(
                cfg.talker, whole, embeds, lengths, cache, a8=a8)
            cache.write_idx = torch.full((b,), s, dtype=torch.int32)
            rslg, rshd, _ = talker_lib.talker_decode_step(
                cfg.talker, whole, t["emb_step"], pos, cache, s)
        h = cfg.talker.n_kv_heads // world
        ref_k = cache.k[:, :, rank * h:(rank + 1) * h]
        out[kind] = (dict(logits=lg, hidden=hd, k=k, step_logits=slg,
                          step_hidden=shd),
                     dict(logits=rlg, hidden=rhd, k=ref_k, step_logits=rslg,
                          step_hidden=rshd))
    out = {kind: tuple({k: v.float().numpy() for k, v in d.items()}
                       for d in pair) for kind, pair in out.items()}
    save(root / f"tpq_{rank}.pkl", out)
