"""Continuous batching: lanes refill with queued requests at chunk
boundaries instead of waiting for the whole wave to drain.  Counterpart of
qwen3_tts_tpu/serve/continuous.py, with its schedule.

A finished stream's lane is re-prefilled with the next queued prompt while
the other lanes keep decoding.  Lane isolation:

  * the refilled lane's prompt overwrites cache slots [0, bucket) of its
    own batch row only (kernels/flash_decode.inject_prompt_lanes);
  * its stale decode slots are unreachable (at or above the restarted
    per-lane cursor) and get overwritten as the new stream decodes;
  * the lane's codec streaming state is zeroed (codec.decoder.reset_lanes).

Per-lane cursors make refills free: the cache capacity bounds ONE stream's
budget, not the session, so any queue length runs in one generation state
per prompt bucket.  Each round dispatches (a) ONE multi-chunk group
(runtime.generate._gen_bulk with per-lane remaining budgets, early exit
when all lanes are done) sized to the soonest-finishing lane, and (b) ONE
batched refill (Generator.refill_lanes) for every lane freed this round.
A single-chunk group follows the initial prefill so the first streams get
audio at chunk granularity (TTFT); group sizes then grow up to
`group_chunks`, floored at 4 chunks, or 2 while requests wait.

On a mesh (parallel/mesh.py; `mesh=None` or a mesh of size 1 changes
nothing), every rank is called with the same queue and returns the same
list.  The schedule is ONE global schedule, decided alike on every rank:
lanes, refills and group sizes.  Each data rank decodes only its lanes
`local_lane_slice(mesh, batch_size)` (its draws the whole batch's, its
group's early exit when every rank's lanes are done), refills the freed
lanes it owns, decodes their audio, and each round gathers only the small
lane state (frames emitted, saw_eos) over the data group, never KV,
logits or weights; the finished results are gathered at the end.  With
n_model > 1 the engine's weights are sharded and its Generator runs the
rounds and refills on the JAX TP schedule, as in serve/batch.py.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core import protocol as P_
from ..io.audio import AudioSample
from ..runtime.generate import SamplerParams
from ..utils.logging import log_event
from .batch import BatchRequest, BatchResult, lane_block, serving_mesh
from .codec_path import LaneCodec


def _floor_pow2(x: int) -> int:
    return 1 << (max(1, int(x)).bit_length() - 1)


class ContinuousBatcher:
    """Schedules a request queue over `batch_size` lanes with lane refill.

    group_chunks: max chunks per dispatched group (power of two).  Groups
    are sized adaptively: 1 chunk right after the initial prefill,
    otherwise the largest power of two <= the soonest-finishing active
    lane's remaining chunks, floored (4 chunks, 2 while requests queue)
    and capped here.

    mesh: module docstring.

    Differences from the JAX batcher: a refill prefills exactly the freed
    lanes: the JAX batcher pads each refill to a power of two (repeating
    its first entry) to bound XLA's compiled shapes, which eager PyTorch
    does not have.  Each round logs a `serve_round` event
    (utils.logging.log_event) in place of QTTS_SCHED_TRACE.
    """

    def __init__(self, engine, batch_size: int = 8,
                 max_frames_per_stream: Optional[int] = None,
                 group_chunks: int = 8, mesh=None):
        self.engine = engine
        self.batch_size = int(batch_size)
        self.max_frames = max_frames_per_stream or engine.max_steps
        self.group_chunks = _floor_pow2(group_chunks)
        self.mesh = serving_mesh(engine, mesh, self.batch_size)

    def run(self, requests: Sequence[BatchRequest]) -> List[BatchResult]:
        results: List[Optional[BatchResult]] = [None] * len(requests)
        self._t0 = time.perf_counter()     # TTFT reference for this queue
        self._ttft = {}                    # request index -> ms of first audio
        eng = self.engine
        # Bucket routing: requests grouped by prompt bucket, so a short
        # prompt never pays a long prompt's prefill padding.
        plans = {}
        buckets = {}
        for i, r in enumerate(requests):
            plans[i] = (r.plan if r.plan is not None
                        else eng._build_voice_prompt(r.text, r.voice,
                                                     r.instruct))
            buckets.setdefault(eng._bucket(plans[i].length), []).append(i)
        with torch.no_grad():
            for bucket in sorted(buckets):
                queue = buckets[bucket]
                while queue:
                    queue = self._run_generation(requests, results, queue,
                                                 plans, bucket)
        if self.mesh is not None:       # each data rank holds its lanes'
            for part in self.mesh.gather_data(results):
                for i, r in enumerate(part):
                    if r is not None:
                        results[i] = r
        return [r if r is not None else
                BatchResult(audio=AudioSample(np.zeros(0, np.float32),
                                              P_.SAMPLE_RATE, 1),
                            frames=0, eos=False)
                for r in results]

    # ------------------------------------------------------------------
    def _run_generation(self, requests, results, queue: List[int],
                        plans, bucket: int) -> List[int]:
        """One generation state: fill lanes, decode groups with batched
        refill until the queue and lanes drain.  Returns the remaining
        queue."""
        eng = self.engine
        cfg = eng.config
        b = self.batch_size
        n_chunk = cfg.runtime.frames_per_chunk

        lane_req: List[Optional[int]] = [None] * b
        first = queue[: b]
        queue = queue[b:]
        init_plans = [plans[i] for i in first]
        while len(init_plans) < b:          # pad idle lanes with plan 0
            init_plans.append(init_plans[0])
        # this rank's lanes [lo, hi): all of them without a mesh
        own = slice(0, b)
        if self.mesh is not None:
            from ..parallel.distributed import local_lane_slice
            own = local_lane_slice(self.mesh, b)
        lo = own.start
        embeds, lens = eng.prompt_to_device(init_plans[own], bucket)
        for slot, req in enumerate(first):
            lane_req[slot] = req

        seed = eng.sampler_config.seed
        if self.mesh is not None:
            seed = self.mesh.shared_seed(seed)
        elif seed is None:
            seed = time.time_ns() & 0x7FFFFFFFFFFFFFFF
        gen = torch.Generator(device=eng.device).manual_seed(seed)
        state = eng.generator.start(
            embeds, torch.from_numpy(lens).to(eng.device), gen)
        state.lanes = lane_block(self.mesh, own, b)
        # idle lanes start done, so they emit nothing
        state.done = torch.tensor([lane_req[i] is None for i in
                                   range(own.start, own.stop)],
                                  device=eng.device)
        sampler = SamplerParams.make(eng.sampler_config)
        codec = LaneCodec(eng, own.stop - lo)

        wavs = {i: [] for i in queue + first}
        kept = {i: [] for i in queue + first}      # codes
        frames = {i: 0 for i in queue + first}

        fresh = True
        while True:
            t_round = time.perf_counter()
            active = [i for i in range(b) if lane_req[i] is not None]
            if not active:
                break

            # per-lane frames remaining, counted from this group's start
            rem = np.zeros(b, np.int32)
            for lane in active:
                req = lane_req[lane]
                budget = requests[req].max_frames or self.max_frames
                rem[lane] = max(0, budget - frames[req])
            # group size: the soonest-finishing active lane's remaining
            # chunks, floored at 4 chunks (2 while requests wait for a
            # lane, so freed lanes refill sooner); 1 chunk right after the
            # initial prefill
            min_chunks = max(1, int(rem[active].min()) // n_chunk)
            floor_c = 2 if queue else 4
            g = 1 if fresh else min(self.group_chunks,
                                    max(floor_c, _floor_pow2(min_chunks)))

            state, codes_np, valid_np, saw_eos_np = codec.run_group(
                state, sampler, prompt_cap=bucket, n_frames=n_chunk,
                max_frames=g * n_chunk, budgets=rem[own],
                uniform_cursor=False)
            t_group = time.perf_counter() - t_round

            # valid is already EOS- and budget-masked; the lane state of
            # every data rank's lanes, in lane order
            ks = valid_np.sum(axis=1).astype(np.int64)
            eos_now = saw_eos_np.astype(bool)
            if self.mesh is not None:
                parts = self.mesh.gather_data((ks, eos_now))
                ks = np.concatenate([p[0] for p in parts])
                eos_now = np.concatenate([p[1] for p in parts])
            finals = np.zeros(b, bool)
            for lane in range(b):
                req = lane_req[lane]
                if req is None:
                    ks[lane], eos_now[lane] = 0, False
                    continue
                budget = requests[req].max_frames or self.max_frames
                finals[lane] = (eos_now[lane]
                                or frames[req] + ks[lane] >= budget)
            samples_own = codec.chunk_audio(codes_np, ks[own], finals[own])

            refill_mask = np.zeros(b, bool)
            refills: List[tuple] = []       # (lane, request index)
            for lane in active:
                req = lane_req[lane]
                k = int(ks[lane])
                mine = own.start <= lane < own.stop
                if k > 0:
                    if req not in self._ttft:
                        self._ttft[req] = round(
                            (time.perf_counter() - self._t0) * 1e3, 1)
                    if mine:
                        wavs[req].append(samples_own[lane - lo])
                        kept[req].append(codes_np[lane - lo, :k])
                    frames[req] += k
                if finals[lane]:
                    if mine:        # other ranks' results come at the end
                        samples = (np.concatenate(wavs[req]) if wavs[req]
                                   else np.zeros(0, np.float32))
                        results[req] = BatchResult(
                            audio=AudioSample(samples.astype(np.float32),
                                              P_.SAMPLE_RATE, 1),
                            frames=frames[req], eos=bool(eos_now[lane]),
                            ttft_ms=self._ttft.get(req),
                            codes=np.concatenate(
                                kept[req] or [np.zeros((0, P_.NUM_CODEBOOKS),
                                                       np.int32)]))
                    lane_req[lane] = None
                    if queue:
                        nxt = queue.pop(0)
                        lane_req[lane] = nxt
                        refill_mask[lane] = True
                        refills.append((lane, nxt))
            # ONE batched refill for every lane freed this round, then ONE
            # codec-state reset.  Lanes done inside the group already carry
            # done=True; the refill clears its lanes' flags, and lanes
            # without a new request stay done.
            fresh = False
            # this rank refills the freed lanes it owns
            mine_r = [(lane, n) for lane, n in refills
                      if own.start <= lane < own.stop]
            if mine_r:
                lanes_r = [lane - lo for lane, _ in mine_r]
                plans_r = [plans[n] for _, n in mine_r]
                lens_r = [min(p.length, bucket) for p in plans_r]
                embeds_r, _ = eng.prompt_to_device(plans_r, bucket)
                state = eng.generator.refill_lanes(state, embeds_r, lens_r,
                                                   lanes_r)
                codec.reset_lanes(refill_mask[own])
            log_event("serve_round", group_chunks=g, active=len(active),
                      refills=len(refills), frames_kept=int(ks.sum()),
                      group_ms=round(t_group * 1e3, 1),
                      round_ms=round((time.perf_counter() - t_round) * 1e3,
                                     1), queued=len(queue))

        return queue
