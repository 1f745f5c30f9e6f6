"""Profiling hooks: ``torch.profiler`` traces and per-step timing (port of
``pygat_tpu/utils/profiling.py``).

The reference's only observability is ``time.time()`` deltas in the train
loop (reference train.py:155,177); this adds device traces (CUPTI on CUDA,
exportable to Perfetto / Chrome tracing), a summary of device time by
kernel name, and a step timer that waits for the device, so a step's time
is its launches and its device work rather than the asynchronous enqueue.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import torch


def _activities(cuda: bool | None):
    from torch.profiler import ProfilerActivity

    if cuda is None:
        cuda = torch.cuda.is_available()
    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])


@contextlib.contextmanager
def trace(path: str | None = None, *, cuda: bool | None = None,
          record_shapes: bool = True):
    """Profile the enclosed block with ``torch.profiler.profile`` (CPU and,
    where there is a GPU or ``cuda=True``, CUDA activities), recording each
    op's input shapes. Yields the profiler; its ``key_averages()`` and
    :func:`top_ops` read it after the block, and ``path`` (when given)
    receives the Chrome-trace JSON."""
    with torch.profiler.profile(activities=_activities(cuda),
                                record_shapes=record_shapes) as prof:
        yield prof
    if path:
        prof.export_chrome_trace(path)


@contextlib.contextmanager
def annotate(name: str):
    """A named region in the trace (``torch.profiler.record_function``)."""
    with torch.profiler.record_function(name):
        yield


def _device_self_us(event) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(event, attr, None)
        if value is not None:
            return float(value)
    return 0.0


def top_ops(prof, k: int = 25, *, shapes: bool = False,
            device: bool = True) -> list[tuple]:
    """The ``k`` largest entries of a finished :func:`trace`, by self time:
    (name, total ms, calls), or with ``shapes`` the operators alone (name,
    input shapes, total ms, calls), one entry per distinct shape list, an
    operator's device self time being that of the kernels it launched
    itself (a kernel replayed from a CUDA graph has no operator, so it
    shows only without ``shapes``). ``device`` ranks by device self time
    (CPU-only entries drop out), else by CPU self time."""
    rows = []
    for ev in prof.key_averages(group_by_input_shape=shapes):
        if shapes and ev.device_type == torch.autograd.DeviceType.CUDA:
            continue  # a kernel's own row has no shapes: its operator's has
        us = _device_self_us(ev) if device else float(ev.self_cpu_time_total)
        if us <= 0:
            continue
        head = (ev.key, str(ev.input_shapes)) if shapes else (ev.key,)
        rows.append((*head, us / 1e3, int(ev.count)))
    rows.sort(key=lambda r: -r[-2])
    return rows[:k]


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def profile_top_ops(fn: Callable, *args, k: int = 25, shapes: bool = False,
                    path: str | None = None, **kw) -> list[tuple]:
    """Run ``fn(*args, **kw)`` once outside the trace (warm-up: kernel
    builds, allocator, caches), then once under :func:`trace`, and return
    its :func:`top_ops`."""
    fn(*args, **kw)
    _sync()
    with trace(path) as prof:
        fn(*args, **kw)
        _sync()
    return top_ops(prof, k, shapes=shapes, device=torch.cuda.is_available())


class StepTimer:
    """Wall-clock step timing that waits for the device.

    ``timed(fn)`` returns a wrapped ``fn`` that synchronizes CUDA after the
    call (where CUDA is in use), so the recorded time is launch plus device
    execution, what a step costs, not just the asynchronous enqueue.
    """

    def __init__(self):
        self.times_ms: list[float] = []

    def timed(self, fn: Callable) -> Callable:
        def wrapped(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            _sync()
            self.times_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        return wrapped

    def summary(self) -> dict:
        if not self.times_ms:
            return {"steps": 0}
        xs = sorted(self.times_ms)
        n = len(xs)
        return {
            "steps": n,
            "mean_ms": sum(xs) / n,
            "p50_ms": xs[n // 2],
            "p90_ms": xs[min(n - 1, int(n * 0.9))],
            "min_ms": xs[0],
            "max_ms": xs[-1],
        }
