"""Client kind "online": callers of the port's OnlineBatcher(engine,
batch_size, bucket).

Arrivals follow the mix (harness/traffic.py): a closed loop of
`arrivals.clients` callers, each sending its next request from the
done-callback of its last one, or an open law, whose requests this thread
sends when they are due and times from then.  Every request's prompt plan
is built once per pool entry during set-up (a server builds it on the
caller's thread, as OnlineRouter does), so the batcher's worker does no
client work.

The batcher's results carry audio but not codes, so the codes of each
lane are read where its rounds return them (LaneCodec.run_chunk), and the
lane of each request where its prompt is prefilled: Generator.start for
the cold start, Generator.refill_lanes after it.  Each prompt the engine
puts on the device (prompt_to_device) is queued with its request; a
prefill has to take exactly the queued prompts, in order and at their
lengths, or the probe records a fault and the run prints no result.
"""

from __future__ import annotations

import copy
import math
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from harness.probe import Probe, fresh, sampler_config
from harness.traffic import Request

ROUND = "serve.round"          # the span of one decode call, for readers


class Client:
    def __init__(self, engine, mix: Dict, pool: List[Request], seed: int,
                 probe: Probe):
        from qwen3_tts_tpu_torch.serve.batch import BatchRequest
        from qwen3_tts_tpu_torch.serve.codec_path import LaneCodec
        from qwen3_tts_tpu_torch.serve.online import OnlineBatcher
        self.eng, self.mix, self.pool, self.probe = engine, mix, pool, probe
        self.BatchRequest = BatchRequest
        # one sampler for every lane: the mix's, greedy where its
        # temperature is 0 (greedy_share needs a sampler per request)
        if mix["greedy_share"]:
            raise ValueError("the online batcher samples every lane alike: "
                             "greedy_share must be 0")
        self.greedy = mix["sampler"]["temperature"] <= 0
        engine.set_sampler_config(sampler_config(mix, self.greedy, seed))
        self.batch = int(mix["batch_size"])
        self.batcher = OnlineBatcher(engine, batch_size=self.batch,
                                     bucket=int(mix["bucket"]))
        self.arrivals = mix["arrivals"]
        self.voices = {r.speaker: engine.get_speaker(r.speaker) for r in pool}
        self.plans = [engine._build_voice_prompt(
            r.text, self.voices[r.speaker], r.instruct) for r in pool]
        self.next_index = 0
        self.next_due: Optional[float] = None
        self.lock = threading.Lock()
        self.submitting = True
        self.done: List[Request] = []
        self.by_plan: Dict[int, Request] = {}
        self.pending: deque = deque()      # prompts on the device, in order
        self.lane: List[Optional[Request]] = [None] * self.batch
        self.lane_codec_cls = LaneCodec

    # ----------------------------------------------------------- probes
    def _take(self, n: int, lengths) -> List[Request]:
        """The n prompts a prefill takes: the n queued, at their lengths."""
        lengths = [int(x) for x in lengths]
        got = [self.pending.popleft() for _ in range(min(n, len(
            self.pending)))]
        if len(got) != n or len(self.pending) or \
                [r.rows for r in got] != lengths:
            self.probe.fail(
                f"a prefill of {n} prompts at lengths {lengths} does not take "
                f"the prompts queued since the last one "
                f"({[r.rows for r in got]}, {len(self.pending)} left): the "
                "benchmark cannot tell which lane serves which request")
        return got

    def _wrap(self):
        eng, pr = self.eng, self.probe

        def prompt_after(out, attrs, args, kwargs):
            for plan in args[0]:
                self.pending.append(self.by_plan.get(id(plan)))

        def cold_before(args, kwargs):
            lens = np.asarray(args[1].cpu())
            lane = int(np.argmax(lens != 1))
            (req,) = self._take(1, [lens[lane]]) or [None]
            self._assign(lane, req)
            return {"lanes": 1, "rows": int(lens[lane])}

        def refill_before(args, kwargs):
            lanes = [int(x) for x in args[3]]
            reqs = self._take(len(lanes), args[2])
            for lane, req in zip(lanes, reqs):
                self._assign(lane, req)
            return {"lanes": len(lanes), "rows": int(sum(args[2]))}

        def chunk_before(args, kwargs):
            cursors = [r.rows + len(r.codes_list) for r in self.lane
                       if r is not None]
            return {"cursors": cursors}

        def chunk_after(out, attrs, args, kwargs):
            _, codes, valid, _ = out
            frames = 0
            for lane, req in enumerate(self.lane):
                k = int(valid[lane].sum())
                if req is None:
                    if k:
                        self.probe.fail(f"lane {lane} served {k} frames "
                                        "with no request in it")
                    continue
                if k:
                    req.codes_list.extend(codes[lane, :k])
                    frames += k
            attrs.update(frames=frames, lanes=self.batch,
                         n=int(codes.shape[1]))

        pr.wrap(eng, "prompt_to_device", "serve.prompt", after=prompt_after)
        pr.wrap(eng.generator, "start", "serve.cold_start", cold_before)
        pr.wrap(eng.generator, "refill_lanes", "serve.refill", refill_before)
        pr.wrap(self.lane_codec_cls, "run_chunk", ROUND, chunk_before,
                chunk_after)
        pr.wrap(self.lane_codec_cls, "chunk_audio", "serve.audio")

    def _assign(self, lane: int, req: Optional[Request]):
        if req is None:
            self.probe.fail(f"lane {lane} prefilled with a prompt the "
                            "benchmark did not send")
            return
        req.lane = lane
        self.lane[lane] = req

    # ---------------------------------------------------------- clients
    def _submit(self, due: Optional[float] = None):
        with self.lock:
            if not self.submitting:
                return
            i = self.next_index % len(self.pool)
            self.next_index += 1
        req = fresh(self.pool[i])
        req.greedy = self.greedy
        req.codes_list = []
        plan = copy.copy(self.plans[i])
        self.by_plan[id(plan)] = req
        req.t_submit = time.perf_counter() if due is None else due
        fut = self.batcher.submit(self.BatchRequest(
            req.text, self.voices[req.speaker], req.instruct,
            max_frames=req.frames, plan=plan))
        fut.add_done_callback(lambda f, r=req, p=plan: self._done(f, r, p))

    def _done(self, fut, req: Request, plan):
        req.t_done = time.perf_counter()
        self.by_plan.pop(id(plan), None)
        lane = getattr(req, "lane", None)
        if lane is not None and self.lane[lane] is req:
            self.lane[lane] = None
        exc = fut.exception()
        if exc is not None:
            req.error = repr(exc)
        else:
            res = fut.result()
            req.served_frames = int(res.frames)
            req.eos = bool(res.eos)
            req.audio = res.audio.samples
        self.done.append(req)
        if self.arrivals["law"] == "closed":
            self._submit()

    def _send_due(self, now: float):
        """Open laws: send every request due by now, timed from its due
        time."""
        while self.next_due <= now and self.submitting:
            due = self.next_due
            self._submit(due)
            gap = self.pool[self.next_index % len(self.pool)].gap_s
            self.next_due = due + gap

    def drive(self, t_end: float, tick=lambda: math.inf):
        """Keep the traffic going until t_end; this thread sleeps but for
        tick(), when it asks, and for the open laws' arrivals."""
        while True:
            wake = min(t_end, tick())
            now = time.perf_counter()
            if now >= t_end:
                return
            if self.next_due is not None:
                self._send_due(now)
                wake = min(wake, self.next_due)
            time.sleep(max(0.0, wake - time.perf_counter()))

    def start(self, warm_in_s: float):
        """Build and load the kernels with one prefill and chunk at the
        cell's batch and bucket (engine.warmup), then let the traffic run
        `warm_in_s` seconds, so that the lanes are out of step."""
        self.eng.warmup(buckets=(int(self.mix["bucket"]),),
                        batch_sizes=(self.batch,))
        self._wrap()
        if self.arrivals["law"] == "closed":
            for _ in range(int(self.arrivals["clients"])):
                self._submit()
        else:
            self.next_due = time.perf_counter() + self.pool[0].gap_s
        self.drive(time.perf_counter() + warm_in_s)

    def stop(self):
        with self.lock:
            self.submitting = False
        self.batcher.stop(timeout=120.0)
        self.probe.restore()

    def finish(self):
        for req in self.done:
            if req.error is None:
                req.codes = (np.stack(req.codes_list).astype(np.int32)
                             if req.codes_list else
                             np.zeros((0, 16), np.int32))
            req.codes_list = []
