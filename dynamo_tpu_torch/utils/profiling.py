"""Device profiling hooks: a ``torch.profiler`` capture, on demand.

The port's copy of ``dynamo_tpu/utils/profiling.py``. The reference wraps
the XLA profiler; the port wraps ``torch.profiler``:

- ``capture_trace(out_dir, seconds)`` records a window of CUDA activity
  with a card (CUPTI lists the port's ctypes-launched kernels under their
  ``__global__`` names), CPU activity without one, into a Chrome trace
  (``trace.json``) and a ``summary.json`` beside it: the device time and
  launch count of each kernel name and the window's kernel-busy share.
  With a card, a capture that holds no CUDA kernel event raises: it is a
  failure, not an empty success. The HTTP service serves it at
  ``GET /debug/profile`` when ``--profile-dir`` is set, and an incident
  bundle's ``--incident-profile-s`` window lands through it.
- The reference's ``enable_profiler_server`` (jax's profiler gRPC server,
  ``--profiler-port``) has no torch counterpart and is not ported: the CLI
  refuses the flag by name.

One capture at a time per process: every path funnels through one lock,
and a loser gets :class:`CaptureBusyError` (a clean 409 or a "skipped"
note) instead of a second profiler session.

The capture never parses its events in the serving process: the trace is
written by the profiler's own writer and ``summary.json`` is computed by a
child process (``python -m dynamo_tpu_torch.utils.profiling <trace>
<seconds>``). On an H100, a 2 s window of CPU and CUDA activity, stopped and
parsed in an executor, froze the front's event loop for seconds (the wave
around it took 20 s against 5 s without it).
"""

from __future__ import annotations

import asyncio
import itertools
import json
import logging
import os
import subprocess
import sys
import threading
import time
import uuid

logger = logging.getLogger(__name__)

TRACE_FILE = "trace.json"
SUMMARY_FILE = "summary.json"

_capture_lock = threading.Lock()

# per-process capture counter: two captures in the same second get their
# own directories
_capture_seq = itertools.count()


class CaptureBusyError(RuntimeError):
    """Another profiler capture is already in flight in this process."""


def trace_dir_name() -> str:
    """Unique-per-capture directory name: timestamp (human ordering) +
    process-local counter + pid + random suffix (captures across processes
    sharing the profile dir)."""
    return (
        time.strftime("trace-%Y%m%d-%H%M%S")
        + f"-{os.getpid()}-{next(_capture_seq):04d}-{uuid.uuid4().hex[:6]}"
    )


def _union_us(intervals) -> float:
    """Length of the union of [start, end) intervals (microseconds)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def summarize_trace(events, window_s: float) -> dict:
    """A Chrome trace's ``traceEvents`` → per-kernel device time and the
    window's kernel-busy share (the union of kernel intervals over the
    capture window, so overlapping kernels on two streams count once)."""
    kernels: dict = {}
    spans = []
    for e in events:
        if e.get("cat") != "kernel" or "dur" not in e:
            continue
        k = kernels.setdefault(e.get("name", "?"), {"launches": 0, "us": 0.0})
        k["launches"] += 1
        k["us"] += float(e["dur"])
        spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    busy_us = _union_us(spans)
    return {
        "window_s": window_s,
        "kernel_launches": sum(k["launches"] for k in kernels.values()),
        "kernel_busy_s": busy_us / 1e6,
        "kernel_busy_share": busy_us / 1e6 / window_s if window_s > 0 else 0.0,
        "kernels": dict(sorted(kernels.items(), key=lambda kv: -kv[1]["us"])),
    }


def prepare_profiler() -> float:
    """Start and stop one empty profiler window in the calling thread (the
    main one, before serving): the first start of a process initialises
    CUPTI, which took 9.8 s on an H100, and a capture taken later while
    serving would block the event loop that long. Returns the seconds it
    took."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.monotonic()
    prof = profile(activities=[ProfilerActivity.CUDA
                               if torch.cuda.is_available()
                               else ProfilerActivity.CPU])
    prof.start()
    prof.stop()
    return time.monotonic() - t0


def _start(out_dir: str):
    """Take the process-wide lock, make the capture's directory and start
    the profiler: CUDA activity with a card (the kernels; a busy server's
    CPU op events would multiply the trace and slow the host it
    measures), CPU activity without one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not _capture_lock.acquire(blocking=False):
        raise CaptureBusyError(
            "a profiler capture is already in flight in this process")
    try:
        trace_dir = os.path.join(out_dir, trace_dir_name())
        # exist_ok=False: a collision fails loudly instead of merging two
        # captures into one directory
        os.makedirs(trace_dir)
        cuda = torch.cuda.is_available()
        prof = profile(activities=[ProfilerActivity.CUDA if cuda
                                   else ProfilerActivity.CPU])
        t0 = time.monotonic()
        prof.start()
        return trace_dir, prof, cuda, time.monotonic() - t0
    except BaseException:
        _capture_lock.release()
        raise


def _finish(trace_dir: str, prof, cuda: bool, seconds: float,
            start_s: float, stop_s: float) -> str:
    """Write the trace, summarize it in a child process (parsing it here
    would hold this process's interpreter lock, and with it the event
    loop), and release the lock. Raises ``RuntimeError`` when a card is
    present but the window holds no CUDA kernel event."""
    try:
        t0 = time.monotonic()
        path = os.path.join(trace_dir, TRACE_FILE)
        prof.export_chrome_trace(path)
        t1 = time.monotonic()
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (root, os.environ.get("PYTHONPATH")) if p))
        subprocess.run([sys.executable, "-m", __name__, path, str(seconds)],
                       env=env, check=True, timeout=600)
        summary = read_summary(trace_dir)
        summary["cuda"] = cuda
        # the capture's own cost: starting, stopping (collecting the
        # activity buffers), writing the trace, the child's summary
        summary["stages_s"] = dict(start=start_s, stop=stop_s,
                                   export=t1 - t0,
                                   summarize=time.monotonic() - t1)
        with open(os.path.join(trace_dir, SUMMARY_FILE), "w") as f:
            json.dump(summary, f, indent=1)
        if cuda and not summary["kernel_launches"]:
            raise RuntimeError(
                f"profiler capture {trace_dir} holds no CUDA kernel event: "
                "CUPTI recorded no device activity in the window")
        return trace_dir
    finally:
        _capture_lock.release()


def capture_trace(out_dir: str, seconds: float) -> str:
    """Record a profiler window; returns the capture's directory.

    Blocking, in the calling thread. Each capture lands in a directory of
    its own. Raises :class:`CaptureBusyError` while another capture holds
    the process-wide lock."""
    trace_dir, prof, cuda, start_s = _start(out_dir)
    try:
        time.sleep(seconds)
        t0 = time.monotonic()
        prof.stop()
        stop_s = time.monotonic() - t0
    except BaseException:
        _capture_lock.release()
        raise
    return _finish(trace_dir, prof, cuda, seconds, start_s, stop_s)


async def capture_trace_async(out_dir: str, seconds: float) -> str:
    """``capture_trace`` from async code. The profiler starts and stops on
    the event loop's thread (CUPTI's init callback must run in the thread
    that registered the profiler's client, the main one: started from an
    executor, a capture recorded no kernel at all on the card); the window
    is an ``asyncio.sleep`` and the trace's writing rides the executor."""
    trace_dir, prof, cuda, start_s = _start(out_dir)
    try:
        await asyncio.sleep(seconds)
        t0 = time.monotonic()
        prof.stop()
        stop_s = time.monotonic() - t0
    except BaseException:
        _capture_lock.release()
        raise
    return await asyncio.get_running_loop().run_in_executor(
        None, _finish, trace_dir, prof, cuda, seconds, start_s, stop_s)


def read_summary(trace_dir: str) -> dict:
    """A capture's ``summary.json``."""
    with open(os.path.join(trace_dir, SUMMARY_FILE)) as f:
        return json.load(f)


def _summarize_file(trace_path: str, seconds: float) -> None:
    """Write ``summary.json`` beside ``trace_path`` (the child's work)."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents") or []
    summary = summarize_trace(events, seconds)
    with open(os.path.join(os.path.dirname(trace_path), SUMMARY_FILE),
              "w") as f:
        json.dump(summary, f, indent=1)


if __name__ == "__main__":
    _summarize_file(sys.argv[1], float(sys.argv[2]))
