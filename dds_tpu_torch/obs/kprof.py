"""Kernel profiling hooks: dispatch (or build) vs device execution.

Port of `dds_tpu/obs/kprof.py`. A PyTorch call on a CUDA tensor returns
once the work is enqueued; only a wait on the device exposes its execution
time. `profiled()` times the two phases apart and records them as the
reference's span names: `kernel.<name>.dispatch` (or `.compile` when a
kernel build ran inside the call — the first fold of a process compiles
`csrc/`) and `kernel.<name>.execute`. The wait is a CUDA event recorded on
the current stream after the dispatch, so a fold waits for its own work,
not for folds that other threads queued later.
"""

from __future__ import annotations

import threading
import time

import torch

from dds_tpu_torch.obs import context as obs_context
from dds_tpu_torch.utils.trace import tracer

_lock = threading.Lock()
_builds = 0  # kernel builds run by this process


def note_build() -> None:
    """Called by a kernel wrapper after it compiled its kernel."""
    global _builds
    with _lock:
        _builds += 1


def wait(out) -> None:
    """Block until the device work that produced `out` has finished."""
    if isinstance(out, torch.Tensor) and out.device.type == "cuda":
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(out.device))
        ev.synchronize()


def profiled(kernel: str, dispatch, **meta):
    """Run `dispatch()` (enqueue device work, return a tensor), wait for
    the device, and record `kernel.<kernel>.{dispatch|compile}` and
    `kernel.<kernel>.execute` spans. Returns the ready result."""
    builds0 = _builds
    t0 = time.perf_counter()
    out = dispatch()
    t1 = time.perf_counter()
    wait(out)
    t2 = time.perf_counter()
    phase = "compile" if _builds != builds0 else "dispatch"
    cur = obs_context.current()
    tracer.record(
        f"kernel.{kernel}.{phase}", (t1 - t0) * 1e3,
        _ctx=obs_context.child(cur) if cur is not None else None, **meta,
    )
    tracer.record(
        f"kernel.{kernel}.execute", (t2 - t1) * 1e3,
        _ctx=obs_context.child(cur) if cur is not None else None, **meta,
    )
    return out

