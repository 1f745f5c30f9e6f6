"""The port's host graph library: a ctypes loader of
``pygat_tpu_torch/csrc/graphops.cpp`` (port of ``pygat_tpu/native``).

Four functions: :func:`build_csr` (edges counting-sorted by receiver, then
sender), :func:`rcm_order` (reverse Cuthill-McKee), :func:`sym_norm_weights`
(``1 / sqrt(deg_r deg_s)`` per edge) and :func:`apply_reorder` (relabel
edges under an order, numpy). The library is compiled with the host C++
compiler (``$CXX``, else ``g++``) at the first call, never at import, into
``pygat_tpu_torch/_build/graphops-<digest>.so``, where the digest covers
the source and the flags, so an edited source is rebuilt and a stale
library never loads; the build publishes by atomic rename, so concurrent
processes are safe. A failed build or load raises with the compiler's
output: nothing drops to numpy behind the caller's back. The numpy versions
stay beside the library as the plain versions (``plain=True``), which the
tests hold the library to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(PKG_DIR, "csrc", "graphops.cpp")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
ABI_VERSION = 1
_I64, _P = ctypes.c_int64, ctypes.c_void_p
# C entry point -> ctypes argtypes; every pointer goes as an address
ENTRY_POINTS = {
    "graphops_build_csr": [_I64, _I64] + [_P] * 5,
    "graphops_rcm_order": [_I64] + [_P] * 3,
    "graphops_sym_norm_weights": [_I64, _I64] + [_P] * 3,
}

_LOCK = threading.Lock()
_lib = None


def compiler() -> str:
    """``$CXX``, else ``g++`` on PATH; raises when neither is there."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx or not shutil.which(cxx):
        raise RuntimeError(f"graphops: no C++ compiler ({cxx or 'g++'} not "
                           "found): set CXX or put g++ on PATH")
    return cxx


def lib_path() -> str:
    """Where the library built from :data:`SRC` with :data:`CXX_FLAGS`
    lives (the digest of both in its name)."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"graphops-{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Build the library unless it is there; returns its path. Raises with
    the compiler's output when the build fails."""
    path = lib_path()
    if os.path.exists(path):
        return path
    cxx = compiler()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, SRC, "-o", tmp],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"graphops: {cxx} failed (rc {proc.returncode}) "
                           f"on {SRC}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def load():
    """The loaded library with every entry point's argtypes set, building
    it first if needed; raises when the build or the load fails or the
    library's ABI is not :data:`ABI_VERSION`."""
    global _lib
    with _LOCK:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in ENTRY_POINTS.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = None
            lib.graphops_abi_version.argtypes = []
            lib.graphops_abi_version.restype = ctypes.c_int32
            abi = lib.graphops_abi_version()
            if abi != ABI_VERSION:
                raise RuntimeError(f"graphops: the library's ABI is {abi}, "
                                   f"this loader's {ABI_VERSION}")
            _lib = lib
        return _lib


def available() -> bool:
    """Whether the library builds and loads here (a probe: the entry
    points themselves raise on a failed build)."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.int32)


def build_csr(senders, receivers, num_nodes: int, *, plain: bool = False):
    """(rowptr [n + 1], col [e], perm [e]), int32: the edges sorted by
    (receiver, sender), ties in input order; ``perm`` maps a sorted
    position to the original edge index."""
    senders, receivers = _i32(senders), _i32(receivers)
    e = len(senders)
    if plain:
        perm = np.lexsort((senders, receivers)).astype(np.int32)
        rowptr = np.zeros(num_nodes + 1, np.int32)
        np.cumsum(np.bincount(receivers, minlength=num_nodes), out=rowptr[1:])
        return rowptr, senders[perm], perm
    rowptr = np.zeros(num_nodes + 1, np.int32)
    col = np.zeros(e, np.int32)
    perm = np.zeros(e, np.int32)
    load().graphops_build_csr(num_nodes, e, senders.ctypes.data,
                              receivers.ctypes.data, rowptr.ctypes.data,
                              col.ctypes.data, perm.ctypes.data)
    return rowptr, col, perm


def rcm_order(rowptr, col, num_nodes: int, *, plain: bool = False
              ) -> np.ndarray:
    """Reverse Cuthill-McKee over the CSR ``(rowptr, col)``: ``order[new_id]
    = old_id``. Deterministic: each component starts at the unvisited node
    of lowest degree (ties by id), and a node's neighbours join the queue
    by (degree, id)."""
    rowptr, col = _i32(rowptr), _i32(col)
    if not plain:
        order = np.zeros(num_nodes, np.int32)
        load().graphops_rcm_order(num_nodes, rowptr.ctypes.data,
                                  col.ctypes.data, order.ctypes.data)
        return order
    degree = np.diff(rowptr)
    visited = np.zeros(num_nodes, bool)
    out: list[int] = []
    for seed in np.argsort(degree, kind="stable"):
        if visited[seed]:
            continue
        visited[seed] = True
        queue = [int(seed)]
        head = 0
        while head < len(queue):
            v = queue[head]
            head += 1
            nbrs = []
            for u in col[rowptr[v]:rowptr[v + 1]]:
                u = int(u)
                if 0 <= u < num_nodes and not visited[u]:
                    visited[u] = True  # marked when collected: multi-edges
                    nbrs.append(u)
            nbrs.sort(key=lambda u: (degree[u], u))
            queue.extend(nbrs)
        out.extend(queue)
    return np.asarray(out[::-1], np.int32)


def sym_norm_weights(senders, receivers, num_nodes: int, *,
                     plain: bool = False) -> np.ndarray:
    """float32 ``1 / sqrt(deg[r] deg[s])`` per edge, ``deg`` the receiver
    counts (0 where a degree is 0): D^-1/2 A D^-1/2 of a 0/1 adjacency."""
    senders, receivers = _i32(senders), _i32(receivers)
    if plain:
        deg = np.bincount(receivers, minlength=num_nodes).astype(np.float32)
        inv = np.where(deg > 0, np.float32(1) / np.sqrt(np.maximum(
            deg, np.float32(1e-30))), np.float32(0)).astype(np.float32)
        return (inv[receivers] * inv[senders]).astype(np.float32)
    w = np.zeros(len(senders), np.float32)
    load().graphops_sym_norm_weights(num_nodes, len(senders),
                                     senders.ctypes.data,
                                     receivers.ctypes.data, w.ctypes.data)
    return w


def apply_reorder(order, senders, receivers):
    """Relabel edges under ``order[new_id] = old_id``: (senders',
    receivers', inverse) with ``inverse[old_id] = new_id``; node data
    follows as ``x_new = x_old[order]``."""
    order = np.asarray(order)
    inverse = np.zeros_like(order)
    inverse[order] = np.arange(len(order), dtype=order.dtype)
    return inverse[senders], inverse[receivers], inverse
