"""Online continuous batching: a long-lived worker that owns one generation
state and serves requests submitted at any time.  Counterpart of
qwen3_tts_tpu/serve/online.py, with its schedule.

`ContinuousBatcher` (serve/continuous.py) drains a fixed queue; this is its
production form: callers `submit()` from any thread and get a
concurrent.futures.Future; the worker keeps one prompt bucket's state warm,
fills free lanes as requests arrive, and parks while idle.  One chunk of
work per loop iteration keeps a new request's wait for a lane at about one
chunk.

  * one prompt bucket per batcher: a prompt longer than `bucket`, or one
    that fails to build, fails its own future (PromptTooLongError) and
    never the scheduler;
  * `batch_size` lanes with per-lane KV cursors; a request holds a lane
    until EOS or its frame budget;
  * the first request prefills alone (cold start): the other lanes get a
    one-row zero prompt, whose one valid row keeps their attention away
    from an all-masked softmax, and start done;
  * a frame budget above the room the state's cache has is cut to it
    (serve/batch.py's clamp), and one that is not a positive integer
    fails its own future at submit();
  * a crash of the loop fails every in-flight future; `stop()` fails the
    pending ones with "scheduler stopped", and so does a submit() after
    it, at once.

`OnlineRouter` runs one batcher per prompt bucket and sends each request
to the smallest bucket that fits; it builds the request's prompt plan once,
on the caller's thread, and starts each bucket's batcher at its first
request.

Differences from the JAX batcher:

  * Refill: every lane the loop fills in one pass is prefilled by ONE
    Generator.refill_lanes call (the JAX loop calls refill_lane once per
    lane); a lane's prompt that fails to build fails only its future, and
    a refill that raises fails the futures of the lanes it was filling.
  * Budgets: each chunk is LaneCodec.run_chunk with the lanes' remaining
    frame budgets, so `valid` comes budget-masked, the run sets `done` on a
    lane that reaches its budget (the JAX loop's `set_done`; here
    runtime/generate._gen_bulk sets GenState.done from the budgets) and
    EOS comes from `saw_eos`, not from `valid.sum() < n_chunk`.
  * Threads: the kernels keep scratch per weights and batch size, not per
    caller, so each round (the refill, the chunk and its audio) runs under
    the engine's `device_lock` (engine.py, "Threads"): an OnlineRouter's
    workers, and a direct request beside a batcher in serve/api, take
    turns round by round.  The worker runs under torch.no_grad() (grad
    mode is per thread: a served result carries no autograd graph) and
    inside torch.cuda.device(engine.device) on a CUDA engine.  Nothing
    falls back: a worker that cannot reach its device raises into the
    futures.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional

import numpy as np
import torch

from ..core import protocol as P_
from ..io.audio import AudioSample
from ..runtime.generate import SamplerParams
from ..utils.logging import get_logger
from .batch import BatchRequest, BatchResult
from .codec_path import LaneCodec

log = get_logger()


class OnlineBatcher:
    """Thread-backed continuous batching with ad-hoc request submission."""

    def __init__(self, engine, batch_size: int = 8, bucket: int = 128,
                 max_frames_per_stream: Optional[int] = None,
                 idle_poll_s: float = 0.05):
        self.engine = engine
        self.batch_size = int(batch_size)
        self.bucket = int(bucket)
        self.max_frames = max_frames_per_stream or engine.max_steps
        self.idle_poll_s = idle_poll_s
        self._queue: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._started = False
        self._start_lock = threading.Lock()
        self._submit_lock = threading.Lock()

    # ------------------------------------------------------------- public
    def start(self) -> "OnlineBatcher":
        with self._start_lock:
            if not self._started:
                self._thread.start()
                self._started = True
        return self

    def submit(self, request: BatchRequest) -> "Future[BatchResult]":
        """Queue a request; returns a Future resolving to a BatchResult.
        A frame budget that is not a positive integer fails the future at
        once, and so does a batcher that has stopped."""
        fut: "Future[BatchResult]" = Future()
        if request.max_frames is not None:
            n = request.max_frames
            if isinstance(n, bool) or not isinstance(n, (int, np.integer)) \
                    or n < 1:
                fut.set_exception(ValueError(
                    f"max_frames must be a positive integer, not {n!r}"))
                return fut
        with self._submit_lock:
            if self._stop.is_set():
                fut.set_exception(RuntimeError("scheduler stopped"))
                return fut
            self._queue.put((request, fut))
        self.start()
        return fut

    def synthesize(self, text: str, voice, instruct=None,
                   max_frames=None) -> "Future[BatchResult]":
        """submit() of a BatchRequest for text in voice."""
        return self.submit(BatchRequest(text, voice, instruct,
                                        max_frames=max_frames))

    def stop(self, timeout: float = 30.0) -> None:
        self._stop.set()
        if self._started:
            self._thread.join(timeout=timeout)
        else:
            self._fail_queued()

    def _fail_queued(self) -> None:
        """Fail every queued request; after this, submit() fails at once
        (the stop flag is set first)."""
        with self._submit_lock:
            while True:
                try:
                    _, fut = self._queue.get_nowait()
                except queue.Empty:
                    break
                if not fut.cancelled():
                    fut.set_exception(RuntimeError("scheduler stopped"))

    # ------------------------------------------------------------- worker
    def _run(self) -> None:
        dev = self.engine.device
        on_device = (torch.cuda.device(dev) if dev.type == "cuda"
                     else contextlib.nullcontext())
        with torch.no_grad(), on_device:
            self._loop()

    def _loop(self) -> None:
        eng = self.engine
        b = self.batch_size
        n_chunk = eng.config.runtime.frames_per_chunk
        sampler = SamplerParams.make(eng.sampler_config)
        lock = eng.device_lock

        state = None
        codec = LaneCodec(eng, b)
        lane_fut: List[Optional[Future]] = [None] * b
        lane_req: List[Optional[BatchRequest]] = [None] * b
        lane_wavs: List[List[np.ndarray]] = [[] for _ in range(b)]
        lane_frames = [0] * b

        def take(lane, req, fut):
            lane_fut[lane], lane_req[lane] = fut, req
            lane_wavs[lane], lane_frames[lane] = [], 0

        def fail(fut, e):
            if fut is not None and not fut.cancelled():
                fut.set_exception(e)

        def cold_start(lane, embeds1, length):
            """Prefill one request into `lane`; the other lanes get a
            one-row zero prompt and start done."""
            embeds = embeds1.new_zeros((b,) + embeds1.shape[1:])
            embeds[lane] = embeds1[0]
            lens = torch.ones(b, dtype=torch.int32)
            lens[lane] = length
            seed = eng.sampler_config.seed
            if seed is None:
                seed = time.time_ns() & 0x7FFFFFFFFFFFFFFF
            st = eng.generator.start(
                embeds, lens.to(eng.device),
                torch.Generator(device=eng.device).manual_seed(seed))
            st.done = torch.arange(b, device=eng.device) != lane
            return st

        def try_fill_lanes():
            nonlocal state
            refills = []        # (lane, request, future, embeds, length)
            for lane in range(b):
                if lane_fut[lane] is not None:
                    continue
                try:
                    req, fut = self._queue.get_nowait()
                except queue.Empty:
                    break
                if fut.cancelled():
                    continue
                try:
                    plan = (req.plan if req.plan is not None else
                            eng._build_voice_prompt(req.text, req.voice,
                                                    req.instruct))
                    embeds, lens = eng.prompt_to_device([plan], self.bucket)
                    if state is None:
                        state = cold_start(lane, embeds, int(lens[0]))
                        take(lane, req, fut)
                    else:
                        refills.append((lane, req, fut, embeds,
                                        int(lens[0])))
                except Exception as e:
                    # per-request isolation: an oversized or malformed
                    # prompt fails its own future, never the scheduler
                    fail(fut, e)
            if not refills:
                return
            lanes = [r[0] for r in refills]
            try:
                state = eng.generator.refill_lanes(
                    state, torch.cat([r[3] for r in refills]),
                    [r[4] for r in refills], lanes)
            except Exception as e:
                for _, _, fut, _, _ in refills:
                    fail(fut, e)
                return
            mask = np.zeros(b, bool)
            mask[lanes] = True
            codec.reset_lanes(mask)
            for lane, req, fut, _, _ in refills:
                take(lane, req, fut)

        def budget(lane):
            # an over-budget request must not run past the KV capacity
            # (serve/batch.py clamps for the same reason): a lane's rows
            # start at the bucket, and its last chunk writes whole
            return min(lane_req[lane].max_frames or self.max_frames,
                       state.cache.capacity - self.bucket - n_chunk)

        def finish(lane: int, eos: bool):
            fut = lane_fut[lane]
            samples = (np.concatenate(lane_wavs[lane]) if lane_wavs[lane]
                       else np.zeros(0, np.float32))
            result = BatchResult(
                audio=AudioSample(samples.astype(np.float32),
                                  P_.SAMPLE_RATE, 1),
                frames=lane_frames[lane], eos=eos)
            lane_fut[lane] = None
            lane_req[lane] = None
            if fut is not None and not fut.cancelled():
                fut.set_result(result)

        try:
            while not self._stop.is_set():
                with lock:
                    try_fill_lanes()
                    active = [i for i in range(b) if lane_fut[i] is not None]
                    if active:
                        rem = np.zeros(b, np.int32)
                        for lane in active:
                            rem[lane] = budget(lane) - lane_frames[lane]
                        state, codes_np, valid_np, eos_np = codec.run_chunk(
                            state, sampler, prompt_cap=self.bucket,
                            n_frames=n_chunk, budgets=rem)
                        ks = valid_np.sum(1)
                        finals = np.zeros(b, bool)
                        for lane in active:
                            finals[lane] = (eos_np[lane] or lane_frames[lane]
                                            + ks[lane] >= budget(lane))
                        samples_all = codec.chunk_audio(codes_np, ks, finals)
                if not active:
                    time.sleep(self.idle_poll_s)
                    continue
                for lane in active:
                    if ks[lane] > 0:
                        lane_wavs[lane].append(samples_all[lane])
                        lane_frames[lane] += int(ks[lane])
                    if finals[lane]:
                        finish(lane, bool(eos_np[lane]))
        except Exception as e:  # scheduler crash: fail every in-flight future
            log.exception("scheduler loop crashed: %s", e)
            self._stop.set()
            for lane in range(b):
                fut = lane_fut[lane]
                lane_fut[lane] = None
                lane_req[lane] = None
                fail(fut, e)

        # drain on stop: lanes in flight return what they have, queued
        # requests fail
        for lane in range(b):
            if lane_fut[lane] is not None:
                finish(lane, eos=False)
        self._fail_queued()


class OnlineRouter:
    """Multi-bucket online batching: one OnlineBatcher per prompt bucket,
    each request routed to the smallest bucket that fits (module
    docstring).  A bucket's batcher starts at its first request, so a
    bucket that sees no traffic holds no KV state.  Each active bucket
    holds `batch_size` lanes of KV (bucket + max_steps slots).  A prompt
    longer than max(buckets) fails its own future with
    PromptTooLongError."""

    def __init__(self, engine, batch_size: int = 4,
                 buckets=(64, 128, 256), **batcher_kw):
        self.engine = engine
        self.buckets = tuple(sorted(int(x) for x in buckets))
        self.batch_size = int(batch_size)
        self._kw = batcher_kw
        self._batchers: dict = {}
        self._lock = threading.Lock()
        self._stopped = False

    def _batcher_for(self, bucket: int) -> OnlineBatcher:
        with self._lock:
            batcher = self._batchers.get(bucket)
            if batcher is None:
                if self._stopped:
                    raise RuntimeError("scheduler stopped")
                batcher = OnlineBatcher(self.engine, self.batch_size,
                                        bucket=bucket, **self._kw)
                self._batchers[bucket] = batcher
            return batcher

    def submit(self, request: BatchRequest) -> "Future[BatchResult]":
        fut: "Future[BatchResult]" = Future()
        try:
            plan = self.engine._build_voice_prompt(
                request.text, request.voice, request.instruct)
            # the built plan goes to the batcher, so the prompt is built
            # once, here, and not again in the worker
            request.plan = plan
        except Exception as e:
            fut.set_exception(e)
            return fut
        for bucket in self.buckets:
            if plan.length <= bucket:
                try:
                    batcher = self._batcher_for(bucket)
                except RuntimeError as e:       # the router has stopped
                    fut.set_exception(e)
                    return fut
                return batcher.submit(request)
        from ..engine import PromptTooLongError
        fut.set_exception(PromptTooLongError(
            f"prompt is {plan.length} rows but the largest serving bucket "
            f"is {self.buckets[-1]}; raise `buckets` or use stream_long"))
        return fut

    def synthesize(self, text: str, voice, instruct=None,
                   max_frames=None) -> "Future[BatchResult]":
        """submit() of a BatchRequest for text in voice."""
        return self.submit(BatchRequest(text, voice, instruct,
                                        max_frames=max_frames))

    def stop(self, timeout: float = 30.0) -> None:
        with self._lock:
            self._stopped = True
            batchers = list(self._batchers.values())
        for batcher in batchers:
            batcher.stop(timeout=timeout)
