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
        "pygat_tpu_torch.ops.large"} <= set(names)
# every kernel has its wrapper, the corner kernels included
assert set(build.launch_counts()) >= {"corner_permute", "fused_v1_window",
                                      "fused_v2_window"}
print(len(names))
"""


def test_port_and_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 22  # every module was imported
