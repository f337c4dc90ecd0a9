"""The generation loop.  Counterpart of qwen3_tts_tpu/runtime/generate.py.

Per frame: sample code_0 from the talker's codec logits (greedy, or
temperature/top-k/top-p with the caller's torch.Generator) -> EOS flags
-> project the talker hidden 2048->1024 (f32) -> predictor: 15 residual
codes -> feedback = sum of the 16 codec embeddings + tts_pad -> one talker
decode step.  `gen_frames` runs a chunk of frames; `_gen_bulk` loops over
chunks with the codec decode of each chunk and stops at the first chunk
boundary where every lane is done (EOS or its frame budget).  That check
reads `done` from the device once per chunk: the one host sync of the
loop.  The talker KV cache and the codec ring are updated in place.

Three decode paths share this loop.  The exact path
(`Generator(fused=False)`) multiplies the engine's weights op by op (bf16,
or the int8 / int4 dicts of ops.quant).  The per-kernel path
(`fused=True, chunk=False`) is the JAX package's per-kernel schedule:
each talker step is one kernels/talker_step call in the Generator's
`talker_mode` (w4a8, int8, w8a8 or bf16: the JAX package's
QTTS_FUSED_TALKER) and each predictor frame one kernels/predictor_frame
call (int8); `fused=True` packs both models' weights once, under
talker_params["fused_<talker_mode>"] (with "talker_step_mode" naming the
mode) and predictor_params["fused_int8"].
The chunk path (`fused=True, chunk=True`; `TtsEngine`'s default on a CUDA
device) runs each chunk of frames as ONE kernels/chunk_step launch
(`_gen_frames_chunk`), for which the Generator also packs the chunk
kernel's predictor and extras under talker_params["chunk"], with the
kernel's scratch made at the first chunk of each batch size and cache
capacity.  The chunk
kernel's talker is w4a8, so it runs only with talker_mode="w4a8" (the JAX
rule `_mode == "w4a8" and chunk_mode()`).  The talker's prompt prefill
multiplies int8 weights a8w8 unless `a8_prefill=False`.

Which kernel runs is decided per call by the kernels' gates, as in the JAX
package: the chunk kernel where its pack is present, the cursor is uniform,
it takes the batch and frame count (1, 8 or 16 lanes; 24 or 32 at <= 4
frames) and the pack routes that batch (`Generator(chunk_batches=...)`:
TtsEngine's default routes CHUNK_BATCHES, chunk=True every batch);
otherwise frame by frame, with the predictor kernel where it takes the
batch and the talker-step kernel where it does, and the exact modules
elsewhere.  Wave batching (serve/batch.py) prefills a whole wave to one
bucket, so its cursor is uniform and a wave of 8-32 lanes can take the
chunk kernel.  Continuous batching (serve/continuous.py) decodes with
per-lane cursors (uniform_cursor=False) and refills freed lanes with
`prefill_lanes`.

The ONNX codec (models/codec/onnx_decoder) decodes outside this loop: an
engine that runs it builds its Generator without codec_params and takes
the codes-only forms, Generator.chunk (gen_frames) and
Generator.run_bulk_codes (_gen_bulk with no decode).

Streaming (TtsEngine.generate_stream, stream_batch) runs one
`gen_frames_with_audio` per chunk (Generator.chunk_with_audio), the first
one `first_chunk_frames` long (Generator.start_first_chunk,
start_plans_first_chunk: the prefill, then that chunk).  A prompt whose
prefix KV the engine keeps (a voice's instruction and reference rows)
prefills only its suffix: `prefill_with_prefix` copies the kept prefix
into a fresh cache and runs the suffix rows at write cursor prefix_len
(Generator.start_with_prefix, start_with_prefix_from_plans).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..core import protocol as P
from ..core.config import EngineConfig
from ..kernels import chunk_step as chunk_kernel
from ..kernels import predictor_frame as predictor_kernel
from ..kernels import talker_step as talker_kernel
from ..models import predictor as predictor_lib
from ..models import talker as talker_lib
from ..models import transformer
from ..kernels.flash_decode import inject_prompt_lanes
from ..models.codec import decoder as codec_decoder
from ..models.transformer import KVCache
from ..ops.sampling import sample_logits
from ..prompt import assemble


@dataclass(frozen=True)
class LaneBlock:
    """The lanes of a GenState are rows [lo, lo + B) of a batch of `total`
    lanes split over the data ranks of a mesh (parallel/, serve/batch.py,
    serve/continuous.py): sampling draws the whole batch's uniforms from
    the shared generator and keeps these rows, and the chunk loop exits
    when `all_done(done)` says every rank's lanes are done, so that the
    ranks draw alike and a lane's draws do not depend on the mesh."""
    lo: int
    total: int
    all_done: Callable[[torch.Tensor], bool]


@dataclass
class GenState:
    cache: KVCache                # talker KV cache (written in place)
    logits: torch.Tensor          # [B, V_codec] f32 logits for the next code_0
    hidden: torch.Tensor          # [B, 2048] talker hidden at that position
    pos: torch.Tensor             # [B] int32 next logical position
    step: int                     # frames generated so far
    done: torch.Tensor            # [B] bool: lane hit EOS (or its budget)
    generator: torch.Generator    # draws for sampled code_0
    lanes: Optional[LaneBlock] = None   # None: the lanes are the batch


@dataclass(frozen=True)
class SamplerParams:
    temperature: float
    top_k: int
    top_p: float

    @staticmethod
    def make(cfg) -> "SamplerParams":
        return SamplerParams(float(cfg.temperature), int(cfg.top_k),
                             float(cfg.top_p))


def cache_capacity(cfg: EngineConfig, s_max: int) -> int:
    """Talker KV capacity for a prompt bucket: the JAX package's formula,
    so that cache shapes match between the two packages."""
    need = s_max + cfg.runtime.max_steps + cfg.runtime.frames_per_chunk
    return ((need + 511) // 512) * 512


def prefill(cfg: EngineConfig, talker_params, embeds: torch.Tensor,
            lengths: torch.Tensor, generator: torch.Generator,
            a8: bool = True) -> GenState:
    """Initial GenState from a right-padded prompt batch.
    embeds: [B, S_max, 2048]; lengths: [B] int32 true lengths; a8: int8
    weights multiply a8w8 (talker.talker_prefill)."""
    b, s_max, _ = embeds.shape
    cache = talker_lib.init_talker_cache(
        cfg.talker, b, cache_capacity(cfg, s_max), embeds.device,
        talker_params)
    logits, hidden, cache = talker_lib.talker_prefill(
        cfg.talker, talker_params, embeds, lengths, cache, a8=a8)
    return GenState(cache=cache, logits=logits, hidden=hidden,
                    pos=lengths.to(torch.int32), step=0,
                    done=torch.zeros(b, dtype=torch.bool,
                                     device=embeds.device),
                    generator=generator)


def prefill_with_prefix(cfg: EngineConfig, talker_params,
                        prefix_k: torch.Tensor, prefix_v: torch.Tensor,
                        prefix_len: int, suffix_embeds: torch.Tensor,
                        suffix_lengths: torch.Tensor,
                        generator: torch.Generator, total_bucket: int,
                        a8: bool = True) -> GenState:
    """Prefill continuing from a kept prompt prefix (JAX
    runtime/generate.py prefill_with_prefix).

    prefix_k/v: [L, B, Hkv, Pcap, Dh], slots [0, prefix_len) of an earlier
    prefill's cache (padded to Pcap); they are copied into slots [0, Pcap)
    of a fresh cache of the capacity `prefill` gives a prompt of
    total_bucket rows, never written.  suffix_embeds: [B, Scap, 2048], the
    task text and activation rows; prefix_len: int; suffix_lengths: [B]
    int32.  The suffix prefills at write cursor prefix_len with positions
    prefix_len.., against slots [0, total_bucket) (transformer_forward_suffix:
    the prefill kernel at start = prefix_len, window = total_bucket).
    Validity stays one range [0, prefix_len + suffix_len), so slots in
    [lengths, total_bucket), stale rows of the earlier prefill included,
    are masked like prompt padding.  total_bucket must be the prompt_cap of
    the decode chunks after it; write_idx is set to it, as after `prefill`.
    """
    b, s_cap, _ = suffix_embeds.shape
    dev = suffix_embeds.device
    p_cap = prefix_k.shape[3]
    cache = talker_lib.init_talker_cache(
        cfg.talker, b, cache_capacity(cfg, total_bucket), dev, talker_params)
    cache.k[:, :, :, :p_cap].copy_(prefix_k)
    cache.v[:, :, :, :p_cap].copy_(prefix_v)
    start = torch.full((b,), int(prefix_len), dtype=torch.int32, device=dev)
    suffix_lengths = suffix_lengths.to(device=dev, dtype=torch.int32)
    lengths = start + suffix_lengths
    cache.lengths = lengths
    cache.write_idx = start
    pos = start.long()[:, None] + torch.arange(s_cap, device=dev)[None, :]
    cos, sin = talker_lib._rope_tables(cfg.talker, talker_lib._pos4(pos))
    hidden_all, cache = transformer_forward_suffix(
        cfg, talker_params, suffix_embeds, cos, sin, cache, total_bucket, a8)
    last = torch.clamp(suffix_lengths.long() - 1, 0, s_cap - 1)
    hidden = hidden_all[torch.arange(b, device=dev), last]
    cache.write_idx = torch.full((b,), total_bucket, dtype=torch.int32,
                                 device=dev)
    return GenState(cache=cache,
                    logits=talker_lib._codec_logits(talker_params, hidden),
                    hidden=hidden, pos=lengths, step=0,
                    done=torch.zeros(b, dtype=torch.bool, device=dev),
                    generator=generator)


def transformer_forward_suffix(cfg: EngineConfig, talker_params,
                               embeds: torch.Tensor, cos: torch.Tensor,
                               sin: torch.Tensor, cache: KVCache,
                               total_bucket: int, a8: bool = True):
    """The talker over the suffix rows at the cache cursor, against slots
    [0, total_bucket) (decoder_forward's S > 1 branch)."""
    return transformer.decoder_forward(
        cfg.talker, talker_params,
        embeds.to(transformer.dtype_of(cfg.talker.dtype)), cos, sin, cache,
        prompt_cap=total_bucket, a8=a8)


def _frame_emb_sum(codec_tables: torch.Tensor,
                   codes: torch.Tensor) -> torch.Tensor:
    """sum_q codec_tables[q][codes[:, q]] for codes [B, 16] -> [B, 2048]
    f32."""
    n_q, rows = codec_tables.shape[0], codec_tables.shape[1]
    flat = codec_tables.reshape(n_q * rows, -1)
    idx = (torch.arange(n_q, device=codes.device)[None, :] * rows
           + codes.long().clamp(0, rows - 1))
    return flat[idx].float().sum(dim=1)


def _predict_frame_dispatch(cfg: EngineConfig, predictor_params, h1024,
                            code0, tables_1024) -> torch.Tensor:
    """The predictor kernel where the Generator packed its weights and the
    kernel takes the batch (JAX generate.py's dispatch), else the exact
    predictor."""
    packed = predictor_params.get("fused_int8")
    if packed is not None and predictor_kernel.supported(cfg.predictor,
                                                         h1024.shape[0]):
        return predictor_kernel.predict_frame_fused(
            cfg.predictor, packed, h1024, code0, tables_1024)
    return predictor_lib.predict_frame(cfg.predictor, predictor_params,
                                       h1024, code0, tables_1024)


def gen_frames(cfg: EngineConfig, talker_params, predictor_params,
               assets_pack: Dict[str, Any], state: GenState,
               sampler: SamplerParams, n_frames: int, prompt_cap: int,
               uniform_cursor: bool = True,
               ) -> Tuple[GenState, torch.Tensor, torch.Tensor]:
    """Generate `n_frames` frames.

    Returns (state, codes [B, n_frames, 16] int32, valid [B, n_frames]
    bool).  Frames after a lane's EOS are generated but flagged invalid;
    the EOS frame itself is invalid too.  Where the Generator packed the
    chunk kernel (talker_params["chunk"]) for this batch, the cursor is
    uniform and the kernel's gate takes the batch and frame count, the
    frames go through it; otherwise they run one by one (JAX generate.py:199-206).
    uniform_cursor=False: each lane writes at its own cursor.
    """
    chunk_pack = talker_params.get("chunk")
    b = state.hidden.shape[0]
    if (chunk_pack is not None and uniform_cursor
            and (chunk_pack["batches"] is None or b in chunk_pack["batches"])
            and chunk_kernel.supported(cfg.talker, cfg.predictor, b,
                                       n_frames)):
        return _gen_frames_chunk(cfg, talker_params, chunk_pack, state,
                                 sampler, n_frames, prompt_cap)
    tables_1024 = assets_pack["codec_tables_1024"]
    proj_w = assets_pack["proj_w"].float()
    proj_b = assets_pack["proj_b"].float()
    tts_pad = assets_pack["tts_pad"].float()
    codes_out, valid_out = [], []
    # a data rank's lanes draw the whole batch's uniforms (LaneBlock)
    rows = ({} if state.lanes is None
            else {"rows": (state.lanes.lo, state.lanes.total)})
    for _ in range(n_frames):
        code0 = sample_logits(state.logits, state.generator,
                              sampler.temperature, sampler.top_k,
                              sampler.top_p, **rows)
        done = state.done | (code0 == P.EOS)
        h1024 = state.hidden.float() @ proj_w.t() + proj_b
        codes = _predict_frame_dispatch(cfg, predictor_params, h1024, code0,
                                        tables_1024)
        feedback = _frame_emb_sum(assets_pack["codec_tables"], codes) \
            + tts_pad
        logits, hidden, cache = talker_lib.talker_decode_step(
            cfg.talker, talker_params, feedback, state.pos, state.cache,
            prompt_cap=prompt_cap, uniform_cursor=uniform_cursor)
        state = GenState(cache=cache, logits=logits, hidden=hidden,
                         pos=state.pos + 1, step=state.step + 1, done=done,
                         generator=state.generator, lanes=state.lanes)
        codes_out.append(codes)
        valid_out.append(~done)
    return state, torch.stack(codes_out, 1), torch.stack(valid_out, 1)


def _gen_frames_chunk(cfg: EngineConfig, talker_params, chunk_pack,
                      state: GenState, sampler: SamplerParams,
                      n_frames: int, prompt_cap: int,
                      ) -> Tuple[GenState, torch.Tensor, torch.Tensor]:
    """gen_frames through the chunk kernel: one uniform per frame and lane
    from state.generator (drawn once per chunk), each lane's talker rope
    rows of positions pos .. pos + n_frames - 1, one gen_chunk_fused call
    (cache written in place; the kernel's scratch for this batch size and
    cache capacity is made at its first chunk and kept in
    chunk_pack["scratch"]), then the
    EOS bookkeeping of gen_frames, lane by lane."""
    dev = state.hidden.device
    b = state.hidden.shape[0]
    scratch = None
    if dev.type == "cuda":
        cap = state.cache.k.shape[3]
        scratch = chunk_pack["scratch"].get((b, cap))
        if scratch is None:
            scratch = chunk_pack["scratch"][(b, cap)] = \
                chunk_kernel.chunk_scratch(cfg.talker, cfg.predictor, dev, b,
                                           cap)
    if state.lanes is None:
        u = torch.rand((n_frames, b), generator=state.generator, device=dev)
    else:
        lo = state.lanes.lo
        u = torch.rand((n_frames, state.lanes.total),
                       generator=state.generator,
                       device=dev)[:, lo:lo + b].contiguous()
    p = (state.pos.long()[None, :]
         + torch.arange(n_frames, device=dev)[:, None])          # [F, B]
    cos, sin = talker_lib._rope_tables(cfg.talker, talker_lib._pos4(p))
    cache = state.cache
    codes, logits, hidden = chunk_kernel.gen_chunk_fused(
        cfg.talker, cfg.predictor, talker_params["fused_w4a8"],
        chunk_pack["pred_w"], chunk_pack["extras"],
        state.logits.float().contiguous(), state.hidden.float().contiguous(),
        cache.k, cache.v, cache.lengths, cache.write_idx,
        cos.float().contiguous(), sin.float().contiguous(), u,
        (sampler.temperature, sampler.top_k, sampler.top_p), prompt_cap,
        scratch=scratch)
    eos = codes[:, :, 0] == P.EOS                             # [B, F]
    cum = torch.cumsum(eos.to(torch.int32), dim=1) > 0
    valid = ~(state.done[:, None] | cum)
    cache.write_idx = cache.write_idx + n_frames
    state = GenState(cache=cache, logits=logits.to(state.logits.dtype),
                     hidden=hidden.to(state.hidden.dtype),
                     pos=state.pos + n_frames, step=state.step + n_frames,
                     done=state.done | cum[:, -1],
                     generator=state.generator, lanes=state.lanes)
    return state, codes, valid


def gen_frames_with_audio(cfg: EngineConfig, talker_params,
                          predictor_params, assets_pack, codec_params,
                          state: GenState,
                          dec_state: codec_decoder.DecoderState,
                          sampler: SamplerParams, n_frames: int,
                          prompt_cap: int, uniform_cursor: bool = True):
    """One chunk of a stream: gen_frames, then the codec decode of its
    codes.  Returns (state, dec_state, codes [B, n, 16], valid [B, n],
    wav [B, n * spf])."""
    state, codes, valid = gen_frames(cfg, talker_params, predictor_params,
                                     assets_pack, state, sampler, n_frames,
                                     prompt_cap, uniform_cursor)
    wav, dec_state = codec_decoder.decode_chunk(cfg.codec_decoder,
                                                codec_params, codes,
                                                dec_state)
    return state, dec_state, codes, valid, wav


def _gen_bulk(cfg: EngineConfig, talker_params, predictor_params,
              assets_pack, codec_params, state: GenState,
              dec_state: Optional[codec_decoder.DecoderState],
              sampler: SamplerParams, budgets=None, *, max_frames: int,
              chunk: int, prompt_cap: int, uniform_cursor: bool = True):
    """Whole-request generation: a loop over `chunk`-frame groups, each
    followed by its codec decode, that exits at the first chunk boundary
    where every lane is done.

    budgets: optional [B] per-lane frame budgets <= max_frames (default
    max_frames); a lane is done when it samples EOS or reaches its
    budget.  Returns (state, dec_state, codes [B, F, 16], valid [B, F],
    wav [B, F*spf] f32, frames_done int, saw_eos [B] bool) with F =
    max_frames rounded up to whole chunks; columns past a lane's budget
    are invalid, so the budget is exact.  saw_eos[i] is True iff lane i
    sampled EOS (rather than running out of budget).  uniform_cursor as in
    gen_frames.  codec_params=None: the codes-only form (the ONNX codec
    decodes them apart), the same loop with no decode; dec_state and wav
    are then None.
    """
    b = state.hidden.shape[0]
    dev = state.hidden.device
    if budgets is None:
        budgets = max_frames
    budgets = torch.as_tensor(budgets, dtype=torch.int32,
                              device=dev).expand(b)
    n_chunks = -(-max_frames // chunk)
    f_cap = n_chunks * chunk
    spf = cfg.codec_decoder.samples_per_frame
    codes_buf = torch.zeros(b, f_cap, P.NUM_CODEBOOKS, dtype=torch.int32,
                            device=dev)
    valid_buf = torch.zeros(b, f_cap, dtype=torch.bool, device=dev)
    wav_buf = (None if codec_params is None else
               torch.zeros(b, f_cap * spf, dtype=torch.float32, device=dev))
    saw_eos = torch.zeros(b, dtype=torch.bool, device=dev)

    ci = 0
    while ci < n_chunks:
        prev_done = state.done
        state, codes, valid = gen_frames(
            cfg, talker_params, predictor_params, assets_pack, state,
            sampler, chunk, prompt_cap, uniform_cursor)
        # gen_frames only flips `done` on a sampled EOS
        saw_eos = saw_eos | (state.done & ~prev_done)
        codes_buf[:, ci * chunk:(ci + 1) * chunk] = codes
        valid_buf[:, ci * chunk:(ci + 1) * chunk] = valid
        if codec_params is not None:
            wav, dec_state = codec_decoder.decode_chunk(
                cfg.codec_decoder, codec_params, codes, dec_state)
            wav_buf[:, ci * chunk * spf:(ci + 1) * chunk * spf] = wav
        state.done = state.done | ((ci + 1) * chunk >= budgets)
        ci += 1
        # the loop's one host sync per chunk (with a LaneBlock, over every
        # data rank's lanes)
        if (bool(state.done.all()) if state.lanes is None
                else state.lanes.all_done(state.done)):
            break
    valid_buf &= torch.arange(f_cap, device=dev)[None, :] < budgets[:, None]
    return (state, dec_state, codes_buf, valid_buf, wav_buf, ci * chunk,
            saw_eos)


def prefill_lanes(cfg: EngineConfig, talker_params, embeds: torch.Tensor,
                  lengths: torch.Tensor, lanes: torch.Tensor,
                  state: GenState, a8: bool = True) -> GenState:
    """Refill R lanes of a running batch with new prompts (continuous
    batching), in place.  embeds: [R, S, 2048] right-padded prompts of one
    bucket S; lengths, lanes: [R] int32 on the state's device, lanes
    distinct or repeated only with identical rows.  The prompts prefill
    into a compact fresh cache of capacity S (the prefill kernel's window
    is S), `inject_prompt_lanes` copies it into slots [0, S) of the lanes,
    and each lane's lengths, write_idx (= S: the decode region starts at
    the bucket, as after `prefill`), pos, logits, hidden and done are set.
    The old occupant's decode slots stay in the cache but sit at or above
    the new cursor, which no attention reads, and are overwritten as the
    new stream decodes.  Other lanes are untouched.  Returns the state."""
    r, s_max, _ = embeds.shape
    lengths = lengths.to(torch.int32)
    compact = talker_lib.init_talker_cache(cfg.talker, r, s_max,
                                           embeds.device, talker_params)
    logits, hidden, compact = talker_lib.talker_prefill(
        cfg.talker, talker_params, embeds, lengths, compact, a8=a8)
    cache = state.cache
    inject_prompt_lanes(cache.k, cache.v, compact.k, compact.v, lanes)
    idx = lanes.long()

    def put(t: torch.Tensor, rows) -> torch.Tensor:
        # a copy: the small state tensors may alias each other
        t = t.clone()
        t[idx] = rows
        return t

    cache.lengths = put(cache.lengths, lengths)
    cache.write_idx = put(cache.write_idx, s_max)
    state.logits = put(state.logits, logits.to(state.logits.dtype))
    state.hidden = put(state.hidden, hidden.to(state.hidden.dtype))
    state.pos = put(state.pos, lengths)
    state.done = put(state.done, False)
    return state


# The batches at which TtsEngine's default chunk path decodes through the
# chunk kernel, by measurement (an H100 80GB HBM3 at 700 W; PERF.md §6): at
# one lane the chunk kernel's 4-frame launch beats four frames of the step
# schedule (talker_step_fused + predict_frame_fused); at 8-32 lanes the
# step schedule is faster, so those batches take it.
CHUNK_BATCHES = (1,)


def fused_unsupported(cfg: EngineConfig, batch: int = 1,
                      talker_mode: str = "w4a8"):
    """The first gate of the fused decode kernels that `cfg` fails at
    `batch` (the talker step in `talker_mode`), or None."""
    return (talker_kernel.unsupported(cfg.talker, batch, talker_mode)
            or predictor_kernel.unsupported(cfg.predictor, batch))


def chunk_unsupported(cfg: EngineConfig, batch: int = 1):
    """The first gate of the chunk kernel that `cfg` fails at `batch` and
    cfg.runtime.frames_per_chunk, or None."""
    return chunk_kernel.unsupported(cfg.talker, cfg.predictor, batch,
                                    cfg.runtime.frames_per_chunk)


class Generator:
    """Holds the weights of one engine and runs the generation steps.

    fused=True packs the talker's weights for the talker-step kernel in
    `talker_mode` and the predictor's int8 kernel weights once, here, from
    bf16 or int8-dict weights, and decodes through the talker-step and
    predictor-frame kernels; chunk=True also packs the chunk kernel's
    predictor and extras and decodes each chunk through kernels/chunk_step
    where its gate holds and `chunk_batches` holds the batch (None: every
    batch the gate takes; gen_frames).  chunk=True without fused=True, or
    with a talker_mode other than "w4a8", or for a config the chunk kernel
    does not take, raises ValueError (the kernels' wrappers raise for
    inputs they do not take; TtsEngine checks the gates before it builds
    anything).  a8_prefill: the talker's prompt prefill multiplies int8
    weights a8w8 (the JAX package's QTTS_A8_PREFILL, on by default)."""

    def __init__(self, cfg: EngineConfig, talker_params, predictor_params,
                 assets_pack, codec_params=None, fused: bool = False,
                 chunk: bool = False, talker_mode: str = "w4a8",
                 a8_prefill: bool = True,
                 chunk_batches: Optional[Tuple[int, ...]] = None):
        self.cfg = cfg
        self.talker_params = talker_params
        self.predictor_params = predictor_params
        self.assets_pack = assets_pack
        self.codec_params = codec_params
        self.talker_mode = talker_mode
        self.a8_prefill = a8_prefill
        if talker_mode not in talker_kernel.MODES:
            raise ValueError(f"talker_mode {talker_mode!r} is not one of "
                             f"{talker_kernel.MODES}")
        if chunk and not fused:
            raise ValueError("the chunk decode path needs fused=True")
        if chunk and talker_mode != "w4a8":
            raise ValueError("the chunk decode path runs the w4a8 talker "
                             f"step, not talker_mode={talker_mode!r}")
        why = chunk_unsupported(cfg) if chunk else None
        if why:
            raise ValueError(why)
        with torch.no_grad():
            if fused:
                self.talker_params = dict(talker_params, **{
                    "fused_" + talker_mode: talker_kernel.prep_layer_weights(
                        cfg.talker, talker_params, talker_mode),
                    "talker_step_mode": talker_mode})
                self.predictor_params = dict(
                    predictor_params,
                    fused_int8=predictor_kernel.prep_predictor_weights(
                        cfg.predictor, predictor_params))
            if chunk:
                self.talker_params["chunk"] = {
                    "pred_w": chunk_kernel.prep_predictor_w4(
                        cfg.predictor, predictor_params),
                    "extras": chunk_kernel.prep_chunk_extras(
                        cfg.talker, cfg.predictor, talker_params,
                        predictor_params, assets_pack),
                    "batches": chunk_batches,
                    "scratch": {}}                  # (batch, cap)

    def start(self, embeds: torch.Tensor, lengths: torch.Tensor,
              generator: torch.Generator) -> GenState:
        return prefill(self.cfg, self.talker_params, embeds, lengths,
                       generator, a8=self.a8_prefill)

    def start_from_plans(self, text_table, codec_tables, text_idx,
                         codec_idx, frame_slot, spk_flag, frames, spk_emb,
                         lengths, generator: torch.Generator) -> GenState:
        """Prompt assembly + prefill.  Args are the stacked padded plan
        arrays (tensors on the tables' device)."""
        embeds = assemble(text_table, codec_tables, text_idx, codec_idx,
                          frame_slot, spk_flag, frames, spk_emb, lengths)
        return self.start(embeds, lengths, generator)

    def start_first_chunk(self, embeds: torch.Tensor, lengths: torch.Tensor,
                          generator: torch.Generator, dec_state,
                          sampler: SamplerParams, prompt_cap: int,
                          n_frames: int = 1):
        """Prefill, then the first n_frames with their audio (a stream's
        first chunk).  Returns (state, dec_state, codes, valid, wav)."""
        state = self.start(embeds, lengths, generator)
        return self.chunk_with_audio(state, dec_state, sampler, prompt_cap,
                                     n_frames=n_frames)

    def start_plans_first_chunk(self, text_table, codec_tables, text_idx,
                                codec_idx, frame_slot, spk_flag, frames,
                                spk_emb, lengths,
                                generator: torch.Generator, dec_state,
                                sampler: SamplerParams, prompt_cap: int,
                                n_frames: int = 1):
        """start_first_chunk from the stacked padded plan arrays (a wave's
        start in TtsEngine.stream_batch).  Returns (state, dec_state,
        codes, valid, wav)."""
        state = self.start_from_plans(text_table, codec_tables, text_idx,
                                      codec_idx, frame_slot, spk_flag,
                                      frames, spk_emb, lengths, generator)
        return self.chunk_with_audio(state, dec_state, sampler, prompt_cap,
                                     n_frames=n_frames)

    def start_with_prefix(self, prefix_k, prefix_v, prefix_len: int,
                          suffix_embeds, suffix_lengths,
                          generator: torch.Generator,
                          total_bucket: int) -> GenState:
        """Prefill reusing a kept prompt-prefix KV (prefill_with_prefix);
        total_bucket must be the prompt_cap of the decode chunks."""
        return prefill_with_prefix(
            self.cfg, self.talker_params, prefix_k, prefix_v, prefix_len,
            suffix_embeds, torch.as_tensor(suffix_lengths,
                                           device=suffix_embeds.device),
            generator, total_bucket, a8=self.a8_prefill)

    def start_with_prefix_from_plans(self, prefix_k, prefix_v,
                                     prefix_len: int, text_table,
                                     codec_tables, text_idx, codec_idx,
                                     frame_slot, spk_flag, frames, spk_emb,
                                     suffix_lengths,
                                     generator: torch.Generator,
                                     total_bucket: int) -> GenState:
        """Suffix assembly from the stacked padded plan arrays, then
        start_with_prefix."""
        embeds = assemble(text_table, codec_tables, text_idx, codec_idx,
                          frame_slot, spk_flag, frames, spk_emb,
                          suffix_lengths)
        return self.start_with_prefix(prefix_k, prefix_v, prefix_len, embeds,
                                      suffix_lengths, generator,
                                      total_bucket)

    def refill_lanes(self, state: GenState, embeds_r: torch.Tensor,
                     lengths, lanes) -> GenState:
        """Prefill len(lanes) lanes of a running batch with new prompts
        (see prefill_lanes).  embeds_r: [R, S, 2048]; lengths, lanes:
        length-R host sequences.  Unlike the JAX package, R is not padded:
        the padding there bounds XLA's compiled shapes, which eager
        PyTorch does not have."""
        b = state.hidden.shape[0]
        lanes = [int(x) for x in lanes]
        if len(lanes) != embeds_r.shape[0] or len(lengths) != len(lanes):
            raise ValueError(f"refill of {embeds_r.shape[0]} prompts with "
                             f"{len(lengths)} lengths and {len(lanes)} lanes")
        if not all(0 <= x < b for x in lanes):
            raise ValueError(f"refill lanes {lanes} outside [0, {b})")
        dev = embeds_r.device
        with torch.no_grad():
            return prefill_lanes(
                self.cfg, self.talker_params, embeds_r,
                torch.tensor(list(lengths), dtype=torch.int32, device=dev),
                torch.tensor(lanes, dtype=torch.int32, device=dev), state,
                a8=self.a8_prefill)

    def run_bulk(self, state: GenState, dec_state, sampler: SamplerParams,
                 prompt_cap: int, max_frames: int, budgets=None,
                 uniform_cursor: bool = True):
        """Whole-request generation with the codec decode fused per chunk
        of cfg.runtime.frames_per_chunk frames (see _gen_bulk).  Returns
        (state, dec_state, codes, valid, wav, frames_done, saw_eos)."""
        if self.codec_params is None:
            raise ValueError("Generator built without codec_params")
        return _gen_bulk(self.cfg, self.talker_params, self.predictor_params,
                         self.assets_pack, self.codec_params, state,
                         dec_state, sampler, budgets, max_frames=max_frames,
                         chunk=self.cfg.runtime.frames_per_chunk,
                         prompt_cap=prompt_cap, uniform_cursor=uniform_cursor)

    def run_bulk_codes(self, state: GenState, sampler: SamplerParams,
                       prompt_cap: int, max_frames: int, budgets=None,
                       uniform_cursor: bool = True):
        """run_bulk without the codec (the ONNX codec decodes the codes
        apart): the same loop, no decode.  Returns (state, codes, valid,
        frames_done, saw_eos)."""
        state, _, codes, valid, _, done, saw_eos = _gen_bulk(
            self.cfg, self.talker_params, self.predictor_params,
            self.assets_pack, None, state, None, sampler, budgets,
            max_frames=max_frames, chunk=self.cfg.runtime.frames_per_chunk,
            prompt_cap=prompt_cap, uniform_cursor=uniform_cursor)
        return state, codes, valid, done, saw_eos

    def chunk(self, state: GenState, sampler: SamplerParams,
              prompt_cap: int, n_frames: Optional[int] = None,
              uniform_cursor: bool = True):
        """One chunk of n_frames (default cfg.runtime.frames_per_chunk)
        without the codec (gen_frames).  Returns (state, codes, valid)."""
        return gen_frames(
            self.cfg, self.talker_params, self.predictor_params,
            self.assets_pack, state, sampler,
            n_frames or self.cfg.runtime.frames_per_chunk, prompt_cap,
            uniform_cursor)

    def chunk_with_audio(self, state: GenState, dec_state,
                         sampler: SamplerParams, prompt_cap: int,
                         n_frames: Optional[int] = None,
                         uniform_cursor: bool = True):
        """One chunk of n_frames (default cfg.runtime.frames_per_chunk)
        with its codec decode (gen_frames_with_audio).  Returns (state,
        dec_state, codes, valid, wav)."""
        if self.codec_params is None:
            raise ValueError("Generator built without codec_params")
        return gen_frames_with_audio(
            self.cfg, self.talker_params, self.predictor_params,
            self.assets_pack, self.codec_params, state, dec_state, sampler,
            n_frames or self.cfg.runtime.frames_per_chunk, prompt_cap,
            uniform_cursor)
