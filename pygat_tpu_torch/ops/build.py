"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``; sources
share device code through the headers ``csrc/*.cuh``. Nothing is built when
a module is imported: the first CUDA call builds every missing library, one
``nvcc`` per source, all started together, into ``pygat_tpu_torch/_build/``.
A library's file name carries a hash of its source, the headers and the
flags, so an edited source or header is rebuilt and a stale library never
loads. Builds publish by atomic rename, so concurrent processes are safe.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# source name -> (C entry point, ctypes argtypes); every entry point takes
# the CUDA stream last, typed as a pointer (ctypes passes an argument past
# argtypes as a 32-bit int, which cuts a stream's address and, on the stack,
# leaves the upper half of its slot as it found it), and returns
# cudaGetLastError() as an int
ENTRY_POINTS = {
    "stream_scatter": ("pygat_stream_scatter", [_P] * 5 + [_I] * 4 + [_P] * 3),
    "fused_v1": ("pygat_fused_v1", [_P] * 9 + [_I] * 5 + [_F] + [_P] * 5),
    "fused_v2": ("pygat_fused_v2", [_P] * 10 + [_I] * 5 + [_F] + [_P] * 5),
    "expand": ("pygat_expand", [_P] * 3 + [_I] * 2 + [_P] * 2),
    "banded_take": ("pygat_banded_take", [_P] * 3 + [_I] * 3 + [_P] * 2),
    "banded_sender_sum": ("pygat_banded_sender_sum",
                          [_P] * 5 + [_I] * 4 + [_P] * 3),
    "fused_v1_banded": ("pygat_fused_v1_banded",
                        [_P] * 10 + [_I] * 5 + [_F] + [_P] * 5),
    "fused_v2_banded": ("pygat_fused_v2_banded",
                        [_P] * 10 + [_I] * 5 + [_F] + [_P] * 5),
    "corner_permute": ("pygat_corner_permute", [_P] * 3 + [_I] * 3 + [_P] * 2),
    "fused_v1_window": ("pygat_fused_v1_window",
                        [_P] * 8 + [_I] * 5 + [_F] + [_P] * 5),
    "fused_v2_window": ("pygat_fused_v2_window",
                        [_P] * 8 + [_I] * 5 + [_F] + [_P] * 5),
    "spmm_banded": ("pygat_spmm_banded", [_P] * 7 + [_I] * 3 + [_P] * 3),
    "panel_spmm": ("pygat_panel_spmm", [_P] * 9 + [_I] * 4 + [_P] * 3),
    "bcsr_attention": ("pygat_bcsr_attention",
                       [_P] * 9 + [_I] * 5 + [_F] + [_P] * 8),
    # the one-limb instantiations of the first three (precision="fastest"):
    # bf16 data or sender tables, the rest as theirs
    "stream_scatter_bf16": ("pygat_stream_scatter_bf16",
                            [_P] * 5 + [_I] * 4 + [_P] * 3),
    "fused_v1_bf16": ("pygat_fused_v1_bf16",
                      [_P] * 9 + [_I] * 5 + [_F] + [_P] * 5),
    "fused_v2_bf16": ("pygat_fused_v2_bf16",
                      [_P] * 10 + [_I] * 5 + [_F] + [_P] * 5),
    # and of rows 5, 6, 8 and the window forms of rows 2, 3 (the band plan
    # and the corner plans under "fastest")
    "banded_take_bf16": ("pygat_banded_take_bf16",
                         [_P] * 3 + [_I] * 3 + [_P] * 2),
    "banded_sender_sum_bf16": ("pygat_banded_sender_sum_bf16",
                               [_P] * 5 + [_I] * 4 + [_P] * 3),
    "fused_v1_banded_bf16": ("pygat_fused_v1_banded_bf16",
                             [_P] * 10 + [_I] * 5 + [_F] + [_P] * 5),
    "fused_v2_banded_bf16": ("pygat_fused_v2_banded_bf16",
                             [_P] * 11 + [_I] * 5 + [_F] + [_P] * 5),
    "fused_v1_window_bf16": ("pygat_fused_v1_window_bf16",
                             [_P] * 8 + [_I] * 5 + [_F] + [_P] * 5),
    "fused_v2_window_bf16": ("pygat_fused_v2_window_bf16",
                             [_P] * 8 + [_I] * 5 + [_F] + [_P] * 5),
}
SOURCES = tuple(ENTRY_POINTS)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_KERNELS: dict[str, ctypes._CFuncPtr] = {}
# kernel name -> its Python wrapper, which counts its launches in
# ``launches``; a kernel is a source's entry point as one wrapper calls it
WRAPPERS: dict = {}


def counted(wrapper=None, *, kernel: str | None = None,
            source: str | None = None):
    """Register ``wrapper`` as the one that launches the kernel ``kernel``
    (by default the wrapper's own name; ``@counted(kernel=...)`` names
    another) through the entry point of ``ENTRY_POINTS[source]`` (by
    default the kernel's own source; the ring's per-hop forwards launch the
    stream forwards' entry points under counts of their own), and start its
    launch count at 0 (the wrapper adds one per launch)."""
    if wrapper is None:
        return lambda w: counted(w, kernel=kernel, source=source)
    name = kernel or wrapper.__name__
    source = source or name
    if source not in ENTRY_POINTS:
        raise KeyError(f"no kernel source named {source}")
    wrapper.kernel, wrapper.source = name, source
    wrapper.launches = 0
    WRAPPERS[name] = wrapper
    return wrapper


def launch_counts() -> dict[str, int]:
    """The launch count of every kernel's wrapper, by kernel name; raises if
    a source of ``ENTRY_POINTS`` has no registered wrapper."""
    missing = set(ENTRY_POINTS) - {w.source for w in WRAPPERS.values()}
    if missing:
        raise KeyError(f"no wrapper launches {sorted(missing)}")
    return {name: w.launches for name, w in WRAPPERS.items()}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default install location."""
    home = os.environ.get("CUDA_HOME")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(fname.encode() + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build_all() -> float:
    """Build every missing kernel library in parallel; returns seconds spent
    (0.0 when all were already built). Raises with nvcc's output on failure.
    The compiler's report (registers, shared memory, spills) is kept beside
    each library as ``<lib>.log``."""
    t0 = time.perf_counter()
    with _LOCK:
        todo = [(n, _lib_path(n)) for n in SOURCES
                if not os.path.exists(_lib_path(n))]
        if not todo:
            return 0.0
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = nvcc_path()
        procs = []
        for name, path in todo:
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC_DIR, f"{name}.cu")]
            procs.append((name, path, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed = []
        for name, path, tmp, proc in procs:
            out, _ = proc.communicate()
            log = out.decode(errors="replace")
            if proc.returncode != 0:
                failed.append(f"--- {name}.cu (rc {proc.returncode})\n{log}")
                continue
            with open(path + ".log", "w") as f:
                f.write(log)
            os.replace(tmp, path)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """The compiler's report for kernel library ``name`` (after a build)."""
    path = _lib_path(name) + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def kernel(name: str):
    """The C entry point of kernel library ``name``, with its argtypes set,
    building all libraries first if any is missing."""
    fn = _KERNELS.get(name)
    if fn is None:
        build_all()
        symbol, argtypes = ENTRY_POINTS[name]
        lib = ctypes.CDLL(_lib_path(name))
        if hasattr(lib, "pygat_tile_spmm_warps"):  # tile_spmm.cuh's kernels
            from pygat_tpu_torch.ops.stream import SPMM_WARPS

            if lib.pygat_tile_spmm_warps() != SPMM_WARPS:
                raise RuntimeError(f"{name}: the kernel's block has "
                                   f"{lib.pygat_tile_spmm_warps()} warps, "
                                   f"ops/stream.py's SPMM_WARPS is "
                                   f"{SPMM_WARPS}")
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _KERNELS[name] = fn
    return fn


def check(rc: int, what: str) -> None:
    """Raise when a kernel entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def launch(wrapper, *args) -> None:
    """Launch the kernel of ``wrapper`` (registered with :func:`counted`)
    on the current stream of its tensors' device and count the launch on
    the wrapper.

    ``args`` are the C entry point's arguments up to the stream: a tensor
    goes as its data pointer (every tensor must be contiguous and on one
    device), None as a null pointer, a number as itself. Raises when the
    entry point returns a CUDA error."""
    name = wrapper.kernel
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    device = tensors[0].device
    for t in tensors:
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{name}: every tensor must be contiguous and "
                             "on the same device")
    fn = kernel(wrapper.source)
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args]
    with torch.cuda.device(device):
        rc = fn(*c_args, torch.cuda.current_stream(device).cuda_stream)
    check(rc, name)
    wrapper.launches += 1
