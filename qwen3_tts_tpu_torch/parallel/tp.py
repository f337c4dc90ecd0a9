"""The explicit tensor-parallel schedule of the decoder.  Counterpart of
qwen3_tts_tpu/parallel/tp.py (jax.shard_map), on torch.distributed.

Every rank of a model group runs the same program on its own blocks:

  * each projection weight holds this rank's block of its CONTRACTION
    axis (parallel/mesh.shard_params).  A projection is x[..., block] @
    w_local followed by ONE all-reduce over the model group
    (mesh.row_parallel), which sums the partial products in f32: qkv, wo,
    gate_up and down, 4 all-reduces a layer.  That all-reduce is the only
    collective of the forward, no op reshards a weight, and the schedule
    is the same on every rank;
  * the rank takes its contiguous head block of q, k and v from the
    all-reduced qkv, keeps those kv heads in its cache and attends through
    the port's kernels at the rank-local head counts:
    flash_gqa_prefill_stacked for S > 1 (the compact refill prefill too),
    flash_gqa_decode_stacked for a step at one cursor,
    flash_gqa_decode_append for per-lane cursors (their plain versions for
    CPU tensors);
  * int4 weights multiply through kernels/int4_matmul.matmul_int4 at
    K / n_model, plain and int8 ones through torch.matmul, int8 ones a8w8
    in a prompt prefill with the row scale of the whole row.

The schedule itself lives in models/transformer.decoder_forward, which
runs it for a tree that shard_params made (the tree names its mesh), so
the talker, the predictor and runtime/generate's frame loop, bulk loop and
Generator run it unchanged: the serving classes shard the engine's weights
once (shard_engine) and use its own Generator.  The functions below are
the JAX package's entry points on that code, on this rank's blocks: batch
rows local_batch(mesh, B) (the ranks of a data index hold the same lanes)
and caches [L, B_local, Hkv / n_model, C, Dh].  write_at: an int is one
cursor for every lane, a [B] int32 tensor per-lane cursors (continuous
batching after a refill).  The caches are written in place.

Agreement within a model group.  Every rank all-reduces the same buffers
in the same order, so the logits after the (replicated) codec head are
bit-equal across the group; every rank seeds its sampler alike, so the
ranks sample the same code 0 and leave every loop at the same step.  A
rank that left a loop early would leave the others waiting in an
all-reduce: loop bounds and exits depend only on the all-reduced logits
and on lane state reduced over the mesh (Mesh.all_done, through
runtime/generate.LaneBlock).  Sampling draws the whole batch's uniforms
(rows of the data rank kept), so a lane's draws do not depend on the mesh.

The JAX tp.py takes plain weights only (its quantized TP is the GSPMD
path), so the reference for int8, int4 and a8 under TP is the port's own
unsharded forward.  Differences from the JAX functions: a torch.Generator
replaces the key; tp_gen_bulk also returns the frames it ran (the serving
classes decode that many) and, like runtime/generate._gen_bulk, runs its
first chunk before it looks at `done`; tp_prefill_lanes refills only this
rank's lanes and needs no padding.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..models import predictor as predictor_lib
from ..models import talker as talker_lib
from ..models import transformer
from ..models.transformer import KVCache
from ..runtime import generate
from ..runtime.generate import GenState, LaneBlock
from .mesh import (Mesh, predictor_param_specs, shard_params, strip_packs,
                   talker_param_specs)


def _on(params: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """params as a rank's block on `mesh`: shard_params' result as it is,
    an unsharded tree named on a mesh of one model rank."""
    held = params.get("mesh")
    if held is mesh:
        return params
    if held is not None or mesh.n_model != 1:
        raise ValueError("the params are not this rank's block on the mesh "
                         "(parallel/mesh.shard_params)")
    return dict(params, mesh=mesh)


def _cursor(write_at, b: int, device):
    """(uniform, write_idx [B] int32) of an int or [B] write cursor."""
    if not torch.is_tensor(write_at) or write_at.dim() == 0:
        return True, torch.full((b,), int(write_at), dtype=torch.int32,
                                device=device)
    return False, write_at.to(torch.int32).contiguous()


def _lanes(mesh: Mesh, b: int) -> LaneBlock:
    """This data rank's b lanes of the mesh's batch."""
    return LaneBlock(mesh.data_index * b, mesh.n_data * b, mesh.all_done)


def _state(mesh, logits, hidden, k_all, v_all, lengths, pos, write_at,
           done=None, generator=None):
    b = logits.shape[0]
    dev = logits.device
    uniform, widx = _cursor(write_at, b, dev)
    cache = KVCache(k=k_all, v=v_all, write_idx=widx,
                    lengths=lengths.to(torch.int32))
    done = (torch.zeros(b, dtype=torch.bool, device=dev) if done is None
            else torch.as_tensor(done, dtype=torch.bool, device=dev)
            .expand(b).clone())
    pos = torch.as_tensor(pos, device=dev).to(torch.int32).expand(b).clone()
    return uniform, GenState(cache=cache, logits=logits, hidden=hidden,
                             pos=pos, step=0, done=done, generator=generator,
                             lanes=_lanes(mesh, b))


def tp_decoder_forward_local(cfg, mesh: Mesh, params_local: Dict[str, Any],
                             x: torch.Tensor, cos: torch.Tensor,
                             sin: torch.Tensor, k_all: torch.Tensor,
                             v_all: torch.Tensor, lengths: torch.Tensor,
                             write_at, prompt_cap: int, a8: bool = False):
    """The decoder on ONE rank (models/transformer.decoder_forward on the
    rank's block).  x: [B, S, D] (the same on the model group); cos/sin:
    [B, S, Dh]; k_all/v_all: [L, B, Hkv / n_model, C, Dh], this rank's kv
    heads, written IN PLACE; lengths: [B] int32; write_at: int or [B]
    int32; a8: S > 1 matmuls of int8 weights a8w8.  Returns (hidden [B, S,
    D] after the final norm, k_all, v_all)."""
    uniform, widx = _cursor(write_at, x.shape[0], x.device)
    cache = KVCache(k=k_all, v=v_all, write_idx=widx,
                    lengths=lengths.to(torch.int32).contiguous())
    hidden, cache = transformer.decoder_forward(
        cfg, _on(params_local, mesh), x, cos, sin, cache, prompt_cap,
        uniform_cursor=uniform, a8=a8)
    return hidden, cache.k, cache.v


def tp_talker_prefill(cfg, mesh: Mesh, talker_params, embeds: torch.Tensor,
                      lengths: torch.Tensor, capacity: int, a8: bool = True):
    """Row-parallel prompt prefill (models/talker.talker_prefill): embeds
    [B, S, 2048], lengths [B] -> (logits [B, V] f32, hidden [B, D] at
    each lane's last real token, k_all, v_all [L, B, Hkv / n_model,
    capacity, Dh] with slots [0, S) written).  a8: int8 weights multiply
    a8w8, the row scale from the whole row."""
    p = _on(talker_params, mesh)
    cache = talker_lib.init_talker_cache(cfg.talker, embeds.shape[0],
                                         capacity, embeds.device, p)
    logits, hidden, cache = talker_lib.talker_prefill(
        cfg.talker, p, embeds, lengths, cache, a8=a8)
    return logits, hidden, cache.k, cache.v


def tp_talker_step(cfg, mesh: Mesh, talker_params, embed: torch.Tensor,
                   pos: torch.Tensor, k_all, v_all, lengths, write_at,
                   prompt_cap: int):
    """One row-parallel decode step (models/talker.talker_decode_step):
    embed [B, 2048], pos [B] -> (logits, hidden, k_all, v_all).  write_at:
    int or [B]."""
    uniform, widx = _cursor(write_at, embed.shape[0], embed.device)
    cache = KVCache(k=k_all, v=v_all, write_idx=widx,
                    lengths=lengths.to(torch.int32))
    logits, hidden, cache = talker_lib.talker_decode_step(
        cfg.talker, _on(talker_params, mesh), embed, pos, cache, prompt_cap,
        uniform_cursor=uniform)
    return logits, hidden, cache.k, cache.v


def tp_predict_frame(cfg, mesh: Mesh, predictor_params, h1024: torch.Tensor,
                     code0: torch.Tensor, tables_1024: torch.Tensor
                     ) -> torch.Tensor:
    """Row-parallel residual-codebook expansion of one frame
    (models/predictor.predict_frame): h1024 [B, 1024], code0 [B] ->
    codes [B, 16] int32."""
    return predictor_lib.predict_frame(cfg.predictor,
                                       _on(predictor_params, mesh), h1024,
                                       code0, tables_1024)


def tp_gen_frames(cfg, mesh: Mesh, talker_params, predictor_params,
                  assets_pack: Dict[str, Any], logits, hidden, k_all, v_all,
                  lengths, pos, write_at0, generator: torch.Generator,
                  sampler, n_frames: int, prompt_cap: int):
    """The row-parallel frame loop (runtime/generate.gen_frames): sample
    code 0 -> predictor frame -> feedback embedding -> talker step, for
    n_frames.  Returns (codes [B, n, 16], valid [B, n] (frames up to this
    call's first EOS of each lane), (logits, hidden, k_all, v_all))."""
    uniform, state = _state(mesh, logits, hidden, k_all, v_all, lengths,
                            pos, write_at0, generator=generator)
    state, codes, valid = generate.gen_frames(
        cfg, _on(talker_params, mesh), _on(predictor_params, mesh),
        assets_pack, state, sampler, n_frames, prompt_cap, uniform)
    return codes, valid, (state.logits, state.hidden, state.cache.k,
                          state.cache.v)


def tp_gen_bulk(cfg, mesh: Mesh, talker_params, predictor_params,
                assets_pack, logits, hidden, k_all, v_all, lengths, pos,
                write_at0, done0, generator: torch.Generator, sampler,
                budgets, max_frames: int, chunk: int, prompt_cap: int):
    """Whole-request generation on the row-parallel schedule
    (runtime/generate._gen_bulk, codes only): `chunk`-frame groups with
    per-lane frame budgets, leaving the loop after a group when every lane
    of every data rank is done (Mesh.all_done).  pos / write_at0 may be
    per-lane.

    Returns (codes [B, F, 16], valid [B, F], saw_eos [B], (logits, hidden,
    k_all, v_all, pos, widx, done), frames run) with F = max_frames
    rounded up to whole chunks; columns past a lane's budget, its EOS or
    the frames run are invalid."""
    uniform, state = _state(mesh, logits, hidden, k_all, v_all, lengths,
                            pos, write_at0, done0, generator)
    state, _, codes, valid, _, n, saw_eos = generate._gen_bulk(
        cfg, _on(talker_params, mesh), _on(predictor_params, mesh),
        assets_pack, None, state, None, sampler, budgets,
        max_frames=max_frames, chunk=chunk, prompt_cap=prompt_cap,
        uniform_cursor=uniform)
    c = state.cache
    return (codes, valid, saw_eos, (state.logits, state.hidden, c.k, c.v,
                                    state.pos, c.write_idx, state.done), n)


def tp_prefill_lanes(cfg, mesh: Mesh, talker_params, embeds: torch.Tensor,
                     new_lengths, lanes, logits, hidden, k_all, v_all,
                     lengths, pos, widx, done, a8: bool = True):
    """Refill R of this rank's lanes with fresh prompts
    (runtime/generate.prefill_lanes on the row-parallel schedule): embeds
    [R, S, 2048]; new_lengths, lanes [R] (distinct, local lane indices).
    A compact [R]-lane cache of capacity S is prefilled row-parallel, then
    inject_prompt_lanes copies its kv heads into slots [0, S) of the lanes
    IN PLACE (the head axis untouched: no collective).  Returns the
    updated (logits, hidden, k_all, v_all, lengths, pos, widx, done); widx
    becomes per-lane, S at the refilled lanes."""
    dev = embeds.device
    _, state = _state(mesh, logits, hidden, k_all, v_all, lengths, pos, widx,
                      done)
    state = generate.prefill_lanes(
        cfg, _on(talker_params, mesh), embeds,
        torch.as_tensor(new_lengths, device=dev).to(torch.int32),
        torch.as_tensor(lanes, device=dev).to(torch.int32).contiguous(),
        state, a8=a8)
    c = state.cache
    return (state.logits, state.hidden, c.k, c.v, c.lengths, state.pos,
            c.write_idx, state.done)


def shard_engine(engine, mesh: Mesh):
    """(talker, predictor) weights of `engine`, this rank's model block
    (shard_params), sharded once: the engine and its Generator keep the
    blocks, and the full copies and packed kernel layouts (strip_packs)
    are dropped, so its Generator runs the exact per-frame path on the
    row-parallel schedule (the fused step, predictor and chunk kernels pack
    full-width layers and never run sharded, nor does the JAX package's
    TP).  A second call with the same mesh returns the same blocks; with
    another, it raises."""
    held = engine.talker_params.get("mesh")
    if held is not None:
        if held is not mesh:
            raise ValueError("the engine's weights are sharded for another "
                             "mesh")
        return engine.talker_params, engine.predictor_params
    talker = shard_params(strip_packs(engine.talker_params), mesh,
                          talker_param_specs())
    predictor = shard_params(strip_packs(engine.predictor_params), mesh,
                             predictor_param_specs())
    engine.talker_params = engine.generator.talker_params = talker
    engine.predictor_params = engine.generator.predictor_params = predictor
    return talker, predictor
