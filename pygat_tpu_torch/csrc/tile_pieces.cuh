// The tile ranges and split tiles of the tile-owner kernels (shared by
// tile_spmm.cuh and tile_fused.cuh).
//
// An edge order is cut into chunks of EC = 256 slots; every chunk writes one
// 128-row output tile, and the chunks of tile t are the contiguous range
// [tile_ptr[t], tile_ptr[t + 1]) (the host derives tile_ptr once per layout
// or plan: ops/stream.py tile_ranges). A tile whose block would walk too
// much (a hub's tile) is cut by the host into pieces at the chunks
// split_at[], one block each: block t walks tile t up to its first cut,
// block n_tiles + e the piece from split_at[e] on. The first piece stores
// into the output, piece e into part[e], and tile_combine_kernel adds the
// pieces into the output in order, so only split tiles pay for it and the
// sum stays reproducible.

#pragma once

#include "slot_rows.cuh"

namespace {

constexpr int PIECE_THREADS = 256;  // threads of the combine kernel

// The first i in [0, n) with a[i] >= v, or n; a is non-decreasing.
__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int n,
                                           int v) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    if (a[lo + half] < v) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

// The tile and chunk range [c_lo, c_hi) that block x walks, and the piece
// it stores (-1: the tile's first piece, which goes to the output; e: the
// extra piece e, which goes to part[e]).
struct TileRange {
  int tile, c_lo, c_hi, piece;
};

__device__ __forceinline__ TileRange tile_range(
    int x, const int* __restrict__ tile_ptr, const int* __restrict__ split_at,
    int n_tiles, int n_split) {
  TileRange t;
  if (x < n_tiles) {
    t.tile = x;
    t.piece = -1;
    t.c_lo = tile_ptr[x];
    t.c_hi = tile_ptr[x + 1];
    if (n_split > 0) {
      const int i = lower_bound(split_at, n_split, t.c_lo + 1);
      if (i < n_split && split_at[i] < t.c_hi) t.c_hi = split_at[i];
    }
  } else {
    const int e = x - n_tiles;
    t.piece = e;
    t.c_lo = split_at[e];
    t.tile = lower_bound(tile_ptr, n_tiles + 1, t.c_lo + 1) - 1;
    t.c_hi = tile_ptr[t.tile + 1];
    if (e + 1 < n_split && split_at[e + 1] < t.c_hi) t.c_hi = split_at[e + 1];
  }
  return t;
}

// out[tile] += part[e], part[e + 1], ... for the extra pieces of each split
// tile, in order, over [128, L] rows; the blocks of a tile's first extra
// piece do the tile, the others return.
__global__ void __launch_bounds__(PIECE_THREADS)
tile_combine_kernel(const int* __restrict__ tile_ptr, int n_tiles,
                    const int* __restrict__ split_at, int n_split, int L,
                    const float* __restrict__ part, float* __restrict__ out) {
  const int e = blockIdx.x;
  const int tile = lower_bound(tile_ptr, n_tiles + 1, split_at[e] + 1) - 1;
  if (e > 0 && split_at[e - 1] > tile_ptr[tile]) return;
  const int t_end = tile_ptr[tile + 1];
  const long long n = static_cast<long long>(TILE) * L;
  const long long i = static_cast<long long>(blockIdx.y) * PIECE_THREADS +
                      threadIdx.x;
  if (i >= n) return;
  float* o = out + tile * n + i;
  float s = *o;
  for (int f = e; f < n_split && split_at[f] < t_end; ++f) s += part[f * n + i];
  *o = s;
}

// Adds the n_split pieces of part [n_split, 128, L] into out [n_tiles * 128,
// L] on `stream`; returns cudaGetLastError() after the launch.
inline int launch_tile_combine(const int* tile_ptr, int n_tiles,
                               const int* split_at, int n_split, int L,
                               const float* part, float* out,
                               cudaStream_t st) {
  if (n_split <= 0 || L <= 0) return 0;
  const dim3 grid(n_split, (TILE * L + PIECE_THREADS - 1) / PIECE_THREADS);
  tile_combine_kernel<<<grid, PIECE_THREADS, 0, st>>>(
      tile_ptr, n_tiles, split_at, n_split, L, part, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
