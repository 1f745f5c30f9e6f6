"""A traced stretch of the window and what it shows: the device's busy
intervals, each kernel by name and class, and the host's work in the
device's idle gaps.

The stretch runs whole chunks under ``torch.profiler`` (CPU and CUDA
activity) after the untimed window has closed. Kernels are classed by
name: the port's own are those whose function the port's CUDA sources
declare ``__global__`` (read from its ``csrc/`` at run time, so a new
kernel is counted without an edit here), GEMMs by their library names,
collectives by NCCL's; every other kernel is a PyTorch op's.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from dataclasses import dataclass, field

GEMM = re.compile(r"gemm|gemv|xmma|cutlass|cublas|splitKreduce|dot_kernel",
                  re.I)
NCCL = re.compile(r"nccl", re.I)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")


def port_kernels() -> set[str]:
    """The ``__global__`` functions of the port's CUDA sources."""
    import pygat_tpu_torch

    csrc = os.path.join(os.path.dirname(pygat_tpu_torch.__file__), "csrc")
    names = set()
    decl = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)"
                      r"\s*)?(\w+)\s*[<(]", re.S)
    for fn in sorted(os.listdir(csrc)):
        if fn.endswith((".cu", ".cuh")):
            with open(os.path.join(csrc, fn)) as f:
                names.update(decl.findall(f.read()))
    return names


ANON = "(anonymous namespace)::"


def base_name(kernel: str) -> str:
    """A demangled kernel's qualified function name: no return type,
    template arguments or parameters, and no anonymous namespace (the
    port's kernels live in one)."""
    head = kernel.replace(ANON, "").split("(")[0].split("<")[0].strip()
    return head.split(" ")[-1]


@dataclass
class Stretch:
    """What one traced stretch showed."""

    epochs: int
    wall_s: float  # host clock around the stretch, ended by a synchronize
    kernels: list = field(default_factory=list)  # (name, start_us, dur_us)
    device_ops: list = field(default_factory=list)  # every device interval
    host: list = field(default_factory=list)  # (name, start_us, dur_us)
    port: set = field(default_factory=set)

    def kind(self, name: str) -> str:
        if NCCL.search(name):
            return "comm"
        if base_name(name) in self.port:  # a namespaced name is not the port's
            return "port"
        if GEMM.search(name):
            return "gemm"
        return "torch"

    def per_epoch_ms(self, kind: str) -> float:
        return sum(d for n, _, d in self.kernels
                   if self.kind(n) == kind) / 1e3 / self.epochs

    def matching_ms(self, pattern: str, after: str | None = None
                    ) -> tuple[float, int]:
        """(device ms per epoch, kernels) of the kernels whose name
        matches ``pattern``, with each kernel matching ``after`` that
        follows one of them directly (the second launch of the same call,
        as the split tiles' combine)."""
        rx = re.compile(pattern)
        rx_after = re.compile(after) if after else None
        hits, follows = [], False
        for name, _, dur in sorted(self.kernels, key=lambda k: k[1]):
            if rx.search(name):
                hits.append(dur)
                follows = True
            elif follows and rx_after and rx_after.search(name):
                hits.append(dur)
            else:
                follows = False
        return sum(hits) / 1e3 / self.epochs, len(hits)

    def busy_intervals(self, collectives: bool = True
                       ) -> list[tuple[float, float]]:
        """The union of the device's intervals, in us, merged; without
        the collectives' kernels when ``collectives`` is false."""
        spans = sorted((s, s + d) for n, s, d in self.device_ops
                       if collectives or not NCCL.search(n))
        merged: list = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self, collectives: bool = True) -> float:
        return sum(e - s for s, e in self.busy_intervals(collectives)) / 1e6

    def top_ops(self, n: int = 10) -> list:
        total: dict = {}
        for name, _, d in self.device_ops:
            total[name] = total.get(name, 0.0) + d / 1e6
        return [[k[:160], v] for k, v in
                sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The longest idle gaps between device intervals, each named by
        the shortest host event that covers its middle."""
        busy = self.busy_intervals()
        gaps = [(e0, s1) for (_, e0), (s1, _) in zip(busy, busy[1:])
                if s1 > e0]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:n]:
            mid = (s + e) / 2
            cover = [(d, name) for name, hs, d in self.host
                     if hs <= mid <= hs + d]
            out.append([min(cover)[1][:160] if cover else "no host event",
                        (e - s) / 1e6])
        return out


def traced_stretch(run_chunk, n_chunks: int) -> Stretch:
    """Run ``n_chunks`` calls of ``run_chunk`` under the profiler; parse
    the trace it writes (in the run's temporary directory, removed)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        epochs = 0
        for _ in range(n_chunks):
            done, _ = run_chunk()
            epochs += done
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    events = events.get("traceEvents", events)
    st = Stretch(epochs=epochs, wall_s=wall, port=port_kernels())
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat, rec = ev.get("cat", ""), (ev.get("name", ""), float(ev["ts"]),
                                       float(ev["dur"]))
        if cat in DEVICE_CATS:
            st.device_ops.append(rec)
            if cat == "kernel":
                st.kernels.append(rec)
        elif cat in HOST_CATS:
            st.host.append(rec)
    return st
