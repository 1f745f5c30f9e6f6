"""Corner-turn: a static row permutation of ``[E, L]`` arrays in k radix
passes (port of ``pygat_tpu/ops/corner.py``).

A plan decomposes the permutation ``out[dest[i]] = x[i]`` into k stable
passes over the destination-tile digits. Each pass reads every output
tile's 128 rows from a contiguous window of ``p`` input tiles starting at
``lo[t]``: output row ``k`` of a pass is ``x[lo[k // 128] * 128 + g[k]]``.
Rows whose source falls outside the capped window are set afterwards by a
fix-up, ``out[ov_dst] = x[ov_src]``. The backward of a permutation is the
inverse permutation: another plan through the same kernel
(:func:`permute_rows` carries both).

Three parts:

* the host half, in numpy and identical to the reference's:
  :class:`CornerPass`, :class:`CornerPlan`, :func:`plan_corner_turn`
  (``care=`` marks the rows whose output is consumed), :func:`plan_pair`
  and :func:`flatten_plan`. The window cap ``_P_MAX = 56`` is a TPU VMEM
  budget; the port keeps it, so that both packages plan the same passes;
* :func:`permute_pass`, one pass: on a CUDA tensor it launches the
  hand-written kernel ``csrc/corner_permute.cu``, which replaces the TPU
  kernel ``pygat_tpu/ops/corner.py::_make_permute_kernel``; on a CPU
  tensor it runs :func:`permute_pass_plain`, the plain PyTorch version that
  is also the kernel's oracle;
* :func:`apply_passes` (the pass chain with the fix-up after each pass),
  :func:`corner_permute` and the differentiable :func:`permute_rows`.

The reference's ``mode`` (``take`` / ``onehot``, ``PYGAT_CORNER_PERMUTE``)
and ``precision`` exist because Mosaic cannot gather rows; the CUDA kernel
reads rows natively and copies them, so every pass is bit-exact f32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from pygat_tpu_torch.ops import build
from pygat_tpu_torch.ops.stream import TILE

# Window-span cap of the reference (a TPU VMEM budget: 56 * 128 * L * 4 B *
# 2 buffers). The radix R is about T^(1/k), and a tile's measured span is R
# plus or minus about R / sqrt(128), so the cap leaves some 4 sigma of slack
# over R; wider tiles are re-windowed and their leftover rows overflow to
# the fix-up.
_P_MAX = 56


class CornerPass(NamedTuple):
    lo: torch.Tensor  # [T] int32 first input tile of each output tile's window
    g: torch.Tensor  # [ceil(T / 8), 8, 128] int32 source row within the window
    p: int  # window width in input tiles
    # rows whose source falls outside the capped window, set by the fix-up
    # after the pass; padded with duplicates of pair 0
    ov_src: torch.Tensor  # [V] int32 input position
    ov_dst: torch.Tensor  # [V] int32 output position
    n_overflow: int

    def to(self, device) -> "CornerPass":
        return self._replace(lo=self.lo.to(device), g=self.g.to(device),
                             ov_src=self.ov_src.to(device),
                             ov_dst=self.ov_dst.to(device))


class CornerPlan(NamedTuple):
    passes: tuple[CornerPass, ...]
    n_rows: int

    @property
    def overflow_total(self) -> int:
        return sum(cp.n_overflow for cp in self.passes)

    def to(self, device) -> "CornerPlan":
        """The same plan with its tensors on ``device``."""
        return self._replace(passes=tuple(cp.to(device) for cp in self.passes))


def _window_cover(src_tile_rows: np.ndarray, p: int) -> int:
    """Best window start (tile id) covering the most of the 128 sorted
    source tiles (a sliding two-pointer scan)."""
    s = np.sort(src_tile_rows)
    best, best_lo, j = -1, int(s[0]), 0
    for i in range(s.shape[0]):
        while s[i] - s[j] >= p:
            j += 1
        if i - j + 1 > best:
            best, best_lo = i - j + 1, int(s[i]) - p + 1
    return max(best_lo, 0)


def _pack_pass(src: np.ndarray, real: np.ndarray, p_cap: int) -> CornerPass:
    """Window/overflow layout of one pass: ``src[j]`` is the input position
    of output position j (``real`` False on rows whose output is never
    consumed: group-alignment padding and don't-care rows)."""
    e_out = src.shape[0]
    t = e_out // TILE
    t_in = int(src[real].max()) // TILE + 1 if real.any() else 1
    j_tile = np.arange(e_out, dtype=np.int64) // TILE
    src_tile = src // TILE
    big = np.iinfo(np.int64).max
    lo = np.full(t, big)
    hi = np.zeros(t, dtype=np.int64)
    np.minimum.at(lo, j_tile[real], src_tile[real])
    np.maximum.at(hi, j_tile[real], src_tile[real])
    lo[lo == big] = 0  # all-pad tiles
    span = hi - lo + 1
    p = int(span.max())
    if p > p_cap:
        # re-window the rare wide tiles around their densest p_cap-tile
        # run; the leftover rows go to the fix-up
        for tt in np.nonzero(span > p_cap)[0]:
            rows = src_tile[tt * TILE:(tt + 1) * TILE][real[tt * TILE:(tt + 1) * TILE]]
            lo[tt] = min(_window_cover(rows, p_cap), max(t_in - p_cap, 0))
        p = p_cap
    in_win = real & (src_tile >= lo[j_tile]) & (src_tile < lo[j_tile] + p)
    g = np.where(in_win, src - lo[j_tile] * TILE, 0).astype(np.int32)
    ov = np.nonzero(real & ~in_win)[0]
    n_ov = ov.shape[0]
    v = max(-(-max(n_ov, 1) // TILE) * TILE, TILE)
    # padding entries duplicate a true (src, dst) pair (an idempotent set)
    pad_src, pad_dst = (src[ov[0]], ov[0]) if n_ov else (src[0], 0)
    ov_src = np.full(v, pad_src, np.int64)
    ov_dst = np.full(v, pad_dst, np.int64)
    ov_src[:n_ov] = src[ov]
    ov_dst[:n_ov] = ov
    g8 = (np.pad(g, (0, (-t % 8) * TILE)).reshape(-1, 8, TILE)
          if t % 8 else g.reshape(t // 8, 8, TILE))
    return CornerPass(
        lo=torch.from_numpy(lo.astype(np.int32)),
        g=torch.from_numpy(np.ascontiguousarray(g8)),
        p=p,
        ov_src=torch.from_numpy(ov_src.astype(np.int32)),
        ov_dst=torch.from_numpy(ov_dst.astype(np.int32)),
        n_overflow=n_ov,
    )


def plan_corner_turn(dest: np.ndarray, p_cap: int = _P_MAX,
                     care: np.ndarray | None = None) -> CornerPlan:
    """Plan the permutation ``out[dest[i]] = x[i]`` (``dest`` a bijection
    on [0, E)); E must be a multiple of 128. The plan's tensors are on the
    CPU.

    MSD prefix passes: pass ``pk`` stable-sorts the rows by the high prefix
    ``dest_tile // R^(k-1-pk)``, refining the previous pass's groups, so
    sources stay contiguous-windowed for uniform (span about R) and nearly
    sorted (span about 1) permutations; intermediate groups are aligned to
    128 rows so that tiles never straddle groups.

    ``care`` (bool [E], default all True): rows with care False get an
    unspecified (but finite) output and are left out of window planning
    (dead stream slots, whose destinations are scattered, would otherwise
    widen the tile spans)."""
    dest = np.asarray(dest, dtype=np.int64)
    e = dest.shape[0]
    if e % TILE:
        raise ValueError(f"rows ({e}) must be a multiple of {TILE}")
    if care is None:
        care = np.ones(e, dtype=bool)
    t = e // TILE
    k = max(1, math.ceil(math.log(max(t, 2)) / math.log(p_cap)))
    r = math.ceil(t ** (1.0 / k))

    row_pos = np.arange(e, dtype=np.int64)  # current position of each row
    passes = []
    for pk in range(k):
        if pk < k - 1:
            key = (dest // TILE) // (r ** (k - 1 - pk))  # per row
            order = np.lexsort((row_pos, key))  # stable within key
            counts = np.bincount(key, minlength=int(key.max()) + 1)
            nz = counts > 0
            padded = -(-counts // TILE) * TILE
            base = np.concatenate([[0], np.cumsum(padded)[:-1]])
            rank = np.empty(e, dtype=np.int64)
            rank[order] = np.arange(e) - np.repeat(
                np.concatenate([[0], np.cumsum(counts[nz])[:-1]]), counts[nz]
            )
            new_pos = base[key] + rank
            e_out = int(padded.sum())
        else:
            new_pos = dest
            e_out = e
        src = np.zeros(e_out, dtype=np.int64)
        real = np.zeros(e_out, dtype=bool)
        src[new_pos] = row_pos
        real[new_pos] = care
        passes.append(_pack_pass(src, real, p_cap))
        row_pos = new_pos
    return CornerPlan(passes=tuple(passes), n_rows=e)


def flatten_plan(plan: CornerPlan):
    """(per-pass tensors ``lo, g, ov_src, ov_dst`` in pass order, the pass
    spans ``p``): the reference's flat form of a plan."""
    return (
        tuple(a for cp in plan.passes
              for a in (cp.lo, cp.g, cp.ov_src, cp.ov_dst)),
        tuple(cp.p for cp in plan.passes),
    )


def plan_pair(dest: np.ndarray) -> tuple[CornerPlan, CornerPlan]:
    """(forward, inverse) plans for ``out[dest[i]] = x[i]``."""
    dest = np.asarray(dest, dtype=np.int64)
    inv = np.empty_like(dest)
    inv[dest] = np.arange(dest.shape[0])
    return plan_corner_turn(dest), plan_corner_turn(inv)


# ---------------------------------------------------------------------------
# One pass: the kernel and its plain version
# ---------------------------------------------------------------------------


def _check_pass(x: torch.Tensor, cp: CornerPass) -> None:
    if x.dim() != 2 or x.dtype != torch.float32 or x.shape[0] % TILE:
        raise ValueError(f"permute_pass: x must be [E_in, L] float32 on "
                         f"128-row tiles, got {x.dtype} {tuple(x.shape)}")
    t = cp.lo.shape[0]
    if cp.g.numel() < t * TILE:
        raise ValueError("permute_pass: g must hold 128 rows per tile of lo")
    for a in (cp.lo, cp.g):
        if a.dtype != torch.int32:
            raise ValueError(f"permute_pass takes int32 indices, got {a.dtype}")


def pass_rows(cp: CornerPass) -> torch.Tensor:
    """[T * 128] int64 input row of every output row of the pass,
    ``lo[k // 128] * 128 + g[k]`` (a dead tile, lo = g = 0, reads row 0)."""
    t = cp.lo.shape[0]
    return (cp.lo.long().repeat_interleave(TILE) * TILE
            + cp.g.reshape(-1)[:t * TILE].long())


def permute_pass_plain(x: torch.Tensor, cp: CornerPass) -> torch.Tensor:
    """Plain PyTorch version of :func:`permute_pass` (a row gather)."""
    _check_pass(x, cp)
    return x[pass_rows(cp)]


@build.counted(kernel="corner_permute")
def permute_pass(x: torch.Tensor, cp: CornerPass) -> torch.Tensor:
    """One pass of a corner-turn plan, without the fix-up: [T * 128, L] f32
    whose row ``k`` is ``x[lo[k // 128] * 128 + g[k]]``, bit-exact. On a
    CUDA tensor this launches ``csrc/corner_permute.cu`` (counted in
    ``permute_pass.launches``); on a CPU tensor it runs
    :func:`permute_pass_plain`. Not differentiable."""
    if x.device.type == "cpu":
        return permute_pass_plain(x, cp)
    if x.device.type != "cuda":
        raise ValueError(f"permute_pass: unsupported device {x.device}")
    _check_pass(x, cp)
    t = cp.lo.shape[0]
    out = torch.empty(t * TILE, x.shape[1], dtype=torch.float32,
                      device=x.device)
    build.launch(permute_pass, x, cp.lo, cp.g, t, cp.p, x.shape[1], out)
    return out


# ---------------------------------------------------------------------------
# The pass chain
# ---------------------------------------------------------------------------


def apply_passes(x: torch.Tensor, plan: CornerPlan) -> torch.Tensor:
    """Every pass of ``plan`` over ``x``, each followed by its fix-up
    ``out[ov_dst] = src[ov_src]`` from the pass's input (a PyTorch
    indexing pair, as the reference's fix-up is XLA outside its kernel).
    A pass's output has ``128 * lo.shape[0]`` rows, which may exceed its
    input's (intermediate groups carry alignment padding). ``n_overflow``
    is a host int of the plan, so the chain never syncs with the device
    (it is captured in the fast loop's CUDA graph); a pass without overflow
    skips the fix-up, whose padding entries would only rewrite row 0 with
    the value the pass gave it."""
    out = x.float()
    for cp in plan.passes:
        src = out
        out = permute_pass(src, cp)
        if cp.n_overflow:
            n = cp.n_overflow
            out.index_copy_(0, cp.ov_dst[:n].long(),
                            src.index_select(0, cp.ov_src[:n].long()))
    return out


def corner_permute(x: torch.Tensor, plan: CornerPlan) -> torch.Tensor:
    """``out[dest[i]] = x[i]`` for the permutation ``plan`` was built from
    (rows planned with ``care`` False get an unspecified finite value). Not
    differentiable: use :func:`permute_rows`."""
    if x.shape[0] != plan.n_rows:
        raise ValueError(f"x rows {x.shape[0]} != plan rows {plan.n_rows}")
    return apply_passes(x, plan)


class _PermuteRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan, plan_inv):
        ctx.plan_inv = plan_inv
        return corner_permute(x.contiguous(), plan)

    @staticmethod
    def backward(ctx, g):
        return corner_permute(g.contiguous(), ctx.plan_inv), None, None


def permute_rows(x: torch.Tensor, plan: CornerPlan,
                 plan_inv: CornerPlan) -> torch.Tensor:
    """Differentiable corner-turn: the backward applies the inverse plan."""
    return _PermuteRows.apply(x, plan, plan_inv)
