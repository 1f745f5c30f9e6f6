"""Static-shape padding helpers (port of ``pygat_tpu/utils/padding.py``).

The port keeps the reference package's padded layouts so both packages see
the same arrays: node counts round up to 128-row tiles (the stream layout's
output tile) and feature widths to multiples of 128.
"""

from __future__ import annotations

import numpy as np

# Row-tile / feature alignment shared with the JAX package.
LANE = 128


def round_up(x: int, multiple: int = LANE) -> int:
    """Round ``x`` up to the next multiple of ``multiple``."""
    if multiple <= 0:
        raise ValueError(f"multiple must be positive, got {multiple}")
    return int(-(-x // multiple) * multiple)


def pad_axis(arr: np.ndarray, size: int, axis: int = 0, value=0) -> np.ndarray:
    """Pad ``arr`` along ``axis`` with ``value`` up to length ``size``."""
    cur = arr.shape[axis]
    if cur > size:
        raise ValueError(f"cannot pad axis {axis} of length {cur} down to {size}")
    if cur == size:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, size - cur)
    return np.pad(arr, widths, mode="constant", constant_values=value)
