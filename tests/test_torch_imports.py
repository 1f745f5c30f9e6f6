"""The PyTorch port and chip_smoke.py never import JAX or the JAX package,
and importing them builds nothing."""

from __future__ import annotations

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, os, pkgutil, sys
import pygat_tpu_torch
names = [m.name for m in pkgutil.walk_packages(pygat_tpu_torch.__path__,
                                               "pygat_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "pygat_tpu"))
assert not bad, bad
from pygat_tpu_torch.ops import build
assert not build._KERNELS
assert {"pygat_tpu_torch.ops.corner", "pygat_tpu_torch.ops.fused_corner",
        "pygat_tpu_torch.ops.large", "pygat_tpu_torch.ops.segment",
        "pygat_tpu_torch.ops.spmm", "pygat_tpu_torch.ops.sddmm",
        "pygat_tpu_torch.ops.panel", "pygat_tpu_torch.legacy_bcsr.tiles",
        "pygat_tpu_torch.legacy_bcsr.fused_attention",
        "pygat_tpu_torch.legacy_bcsr.sparse_attention",
        "pygat_tpu_torch.data.ppi", "pygat_tpu_torch.train.inductive",
        "pygat_tpu_torch.cli.train_ppi"} <= set(names)
# every kernel has its wrapper, the corner, SpMM and BCSR kernels included
assert set(build.launch_counts()) >= {"corner_permute", "fused_v1_window",
                                      "fused_v2_window", "spmm_banded",
                                      "panel_spmm", "bcsr_attention"}
# the SpMM family is exported as the JAX package exports it
from pygat_tpu_torch import ops
for name in ("spmm", "spmm_graph", "sddmm", "sddmm_graph", "panel_spmm",
             "panel_spmm_graph", "build_panel_layout", "spmm_banded",
             "spmm_corner_graph", "segment_sum", "gather_senders",
             "gather_receivers", "segment_sum_receivers",
             "segment_sum_senders", "segment_max", "sorted_segment_sum",
             "sorted_segment_max", "sender_segment_sum",
             "segment_softmax_stable"):
    assert callable(getattr(ops, name)), name
print(len(names))
"""


def test_port_and_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 30  # every module was imported


def test_entry_points_type_every_argument_and_the_stream():
    """Each kernel library's C entry point takes as many arguments as its
    ctypes argtypes name, the CUDA stream last as a pointer (an argument
    past argtypes would go as a 32-bit int: a cut, or on the stack
    half-undefined, stream address)."""
    import ctypes
    import re

    from pygat_tpu_torch.ops import build

    for name, (symbol, types) in build.ENTRY_POINTS.items():
        with open(os.path.join(build.CSRC_DIR, f"{name}.cu")) as f:
            src = f.read()
        params = re.search(r'extern "C" int ' + symbol + r"\((.*?)\)\s*\{",
                           src, re.S).group(1)
        assert len(params.split(",")) == len(types), name
        assert params.split(",")[-1].split() == ["void*", "stream"], name
        assert types[-1] is ctypes.c_void_p, name
