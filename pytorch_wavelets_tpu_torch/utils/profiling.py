"""Timing and tracing utilities (port of
``pytorch_wavelets_tpu/utils/profiling.py``, the names and meaning of
its functions).

Measurement model: a workload is chained ``repeats`` times, each output
feeding the next input (so no call can be skipped), and timed as a
whole; the fixed cost of timing a trivial op the same way is subtracted.
On a CUDA device the time is that of CUDA events around the chain (device
time from the first launch to the last kernel's end, the host's launch
gaps included), on the CPU ``time.perf_counter``.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["time_op", "trace", "mpix_per_s", "coeff_loss"]


def _best_of(f, iters, cuda):
    """The least of ``iters`` timed calls of ``f``, after one untimed
    call (kernel builds, allocator warm-up), in seconds."""
    f()
    if cuda:
        torch.cuda.synchronize()
    best = float("inf")
    for _ in range(iters):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            f()
            end.record()
            end.synchronize()
            t = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            f()
            t = time.perf_counter() - t0
        best = min(best, t)
    return best


def time_op(fn, x, repeats: int = 100, iters: int = 5, device=None) -> float:
    """Per-call seconds of ``fn`` (shape-preserving) on ``x``: ``fn``
    chained ``repeats`` times, the best of ``iters`` chains, less the time
    of a trivial op (``x.sum() * 0``) timed the same way, over
    ``repeats``.  ``device`` (default ``x``'s) picks CUDA events or the
    CPU clock."""
    device = torch.device(device) if device is not None else x.device
    cuda = device.type == "cuda"

    def chained():
        z = x
        for _ in range(repeats):
            z = fn(z)
        return z

    lat = _best_of(lambda: x.sum() * 0.0, iters, cuda)
    tot = _best_of(chained, iters, cuda)
    return max(tot - lat, 1e-9) / repeats


def mpix_per_s(shape, seconds: float) -> float:
    """Millions of elements of ``shape`` per second in ``seconds``."""
    n = 1.0
    for s in shape:
        n *= s
    return n / 1e6 / seconds


def coeff_loss(out):
    """Sum of squares over every tensor of ``out`` (a tensor or nested
    tuples/lists, None entries skipped): a scalar loss whose backward
    runs the transform's backward alone (DWT/DTCWT tuples, SWT lists,
    scattering outputs)."""
    if isinstance(out, (list, tuple)):
        return sum(coeff_loss(v) for v in out)
    return 0 if out is None else (out ** 2).sum()


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` context over the CPU and, where there is one,
    the CUDA device; on exit writes a Chrome trace (``trace-<pid>-<ns>
    .json``) into ``logdir``.  Yields the profiler (``key_averages()``
    reads its table)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
