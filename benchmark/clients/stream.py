"""Client kind "stream": one caller of TtsEngine.generate_stream.  Before
each request it sets the request's frame budget (set_max_steps) and
sampler; it reads every chunk, and starts the next request when the last
chunk is read.  Times the first chunk and every gap between chunks."""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from harness.probe import Probe, fresh, sampler_config
from harness.traffic import Request

ROUND = "engine.chunk"         # the span of one decode call, for readers


class Client:
    def __init__(self, engine, mix: Dict, pool: List[Request], seed: int,
                 probe: Probe):
        if mix["arrivals"] != {"law": "closed", "clients": 1}:
            raise ValueError("the stream client is one closed-loop caller")
        self.eng, self.mix, self.pool, self.probe = engine, mix, pool, probe
        self.seed = int(seed)
        self.next_index = 0
        self.done: List[Request] = []
        self.started: List[Request] = []
        state = {"cursor": 0}
        self._state = state

        def chunk_before(args, kwargs):
            return {"cursor": state["cursor"], "frames": kwargs["n_frames"],
                    "lanes": 1}

        def chunk_after(out, attrs, args, kwargs):
            state["cursor"] += kwargs["n_frames"]

        probe.wrap(engine.codec, "chunk", ROUND, chunk_before, chunk_after)
        probe.wrap(engine.codec, "audio", "engine.audio")
        probe.wrap(engine, "_start_state", "engine.prefill")

    def one(self, stop_at: float) -> Request:
        req = fresh(self.pool[self.next_index % len(self.pool)])
        self.next_index += 1
        eng = self.eng
        eng.set_max_steps(req.frames)
        eng.set_sampler_config(sampler_config(
            self.mix, req.greedy, (self.seed * 1_000_003 + self.next_index)
            % (2 ** 63)))
        voice = eng.get_speaker(req.speaker)
        self._state["cursor"] = req.rows
        self.started.append(req)
        pieces = []
        req.t_submit = time.perf_counter()
        prev = None
        stream = eng.generate_stream(req.text, voice, req.instruct)
        try:
            for piece in stream:
                t = time.perf_counter()
                if prev is None:
                    req.t_first = t
                else:
                    req.gaps.append((prev, t))
                prev = t
                pieces.append(piece)
                if t > stop_at:
                    return req
        finally:
            stream.close()
        req.t_done = time.perf_counter()
        req.codes = np.asarray(eng.last_codes, np.int32).copy()
        req.served_frames = int(req.codes.shape[0])
        req.eos = bool(eng.last_metrics.eos)
        req.prefill_ms = float(eng.last_metrics.prefill_ms)
        req.audio = (np.concatenate(pieces) if pieces
                     else np.zeros(0, np.float32))
        self.done.append(req)
        return req

    def drive(self, t_end: float, tick=lambda: 0.0):
        """Requests back to back until t_end; tick() between them and
        after each."""
        while time.perf_counter() < t_end:
            tick()
            self.one(t_end)
            tick()

    def start(self, warm_in_s: float):
        self.drive(time.perf_counter() + warm_in_s)

    def stop(self):
        self.probe.restore()

    def finish(self):
        pass
