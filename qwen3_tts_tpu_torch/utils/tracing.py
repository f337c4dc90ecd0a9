"""Profiling and debugging hooks.  Counterpart of
qwen3_tts_tpu/utils/tracing.py, on torch.profiler and CUDA in place of
jax.profiler and jax's debug flags.

Environment switches (all opt-in; off, they cost nothing):
  QTTS_PROFILE_DIR=<dir>   a torch.profiler trace (CPU and CUDA activities)
                           of each request, written into <dir> as a Chrome
                           trace file, `<tag>-<pid>-<n>.pt.trace.json`
                           (chrome://tracing or Perfetto)
  QTTS_DEBUG_NANS=1        check the logits and hidden state after each
                           prefill and chunk, and each chunk's audio, and
                           raise FloatingPointError naming the one that is
                           not finite (one reduction and one device sync a
                           check)
  QTTS_CHECKS=1            the kernel wrappers synchronize after each launch
                           and check for a CUDA error, so that an
                           asynchronous fault names the kernel that caused
                           it (kernels/build.check)

A stated departure: the JAX module's docstring promises a trace of each
generation, but the JAX engine never calls `maybe_profile`.  The port's
TtsEngine wraps its requests in it (`_run_inference`, under
generate_with_voice, generate and generate_long; `generate_stream`, under
stream_long; `stream_batch`), so QTTS_PROFILE_DIR does trace each
request.  `apply_debug_flags()` reads QTTS_DEBUG_NANS and QTTS_CHECKS once
per TtsEngine construction (as the JAX engine calls it), into
DEBUG_NANS and CHECKS; the latest engine's environment holds for the
process, as jax's config does.
"""

from __future__ import annotations

import contextlib
import itertools
import os

DEBUG_NANS = False
CHECKS = False
_TRACES = itertools.count()


def apply_debug_flags() -> None:
    global DEBUG_NANS, CHECKS
    DEBUG_NANS = bool(os.environ.get("QTTS_DEBUG_NANS"))
    CHECKS = bool(os.environ.get("QTTS_CHECKS"))


def check_finite(where: str, **tensors) -> None:
    """With QTTS_DEBUG_NANS: raise FloatingPointError naming the first of
    `tensors` (None entries skipped) with a value that is not finite."""
    if not DEBUG_NANS:
        return
    import torch
    named = [(k, t) for k, t in tensors.items() if t is not None]
    if not named:
        return
    ok = torch.stack([torch.isfinite(t).all() for _, t in named]).cpu()
    for (name, _), good in zip(named, ok.tolist()):
        if not good:
            raise FloatingPointError(
                f"QTTS_DEBUG_NANS: {name} is not finite after {where}")


@contextlib.contextmanager
def maybe_profile(tag: str):
    """Trace the enclosed block when QTTS_PROFILE_DIR is set."""
    profile_dir = os.environ.get("QTTS_PROFILE_DIR")
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    os.makedirs(profile_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(tag):
            yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        profile_dir, f"{tag}-{os.getpid()}-{next(_TRACES)}.pt.trace.json"))
