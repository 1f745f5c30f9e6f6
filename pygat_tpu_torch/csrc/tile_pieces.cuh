// The tile ranges and split tiles of the tile-owner kernels (shared by
// tile_spmm.cuh, tile_fused.cuh and tile_sum.cuh), and the lane column
// loads and stores of the last two (loads from f32 rows, or from bf16 rows
// for their one-limb instantiations, widened to f32 exactly).
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

#include <cuda_bf16.h>

#include "slot_rows.cuh"

namespace {

constexpr int PIECE_THREADS = 256;  // threads of the combine kernel
constexpr int PIECE_BATCH = 16;     // pieces' loads a thread has in flight

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

// A lane's columns of a row, for the tile-owner bodies tile_fused.cuh and
// tile_sum.cuh (a lane covers C consecutive columns, as float4 under kVec).
// Columns 0 .. nf - 1 of src into v, zeros past them (nf: 0, or C, or a
// multiple of 4 under kVec).
template <int C, bool kVec>
__device__ __forceinline__ void load_cols(const float* __restrict__ src,
                                          int nf, float (&v)[C]) {
  if constexpr (kVec) {
#pragma unroll
    for (int j = 0; j < C / 4; ++j) {
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      if (4 * j < nf) t = __ldg(reinterpret_cast<const float4*>(src) + j);
      v[4 * j] = t.x;
      v[4 * j + 1] = t.y;
      v[4 * j + 2] = t.z;
      v[4 * j + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < C; ++i) v[i] = i < nf ? __ldg(src + i) : 0.f;
  }
}

// The same from a bf16 row (kVec: 4 values, 8 bytes, a load; nf a
// multiple of 4). A bf16 value is the top half of the f32 of the same
// value, so the widening is a shift.
template <int C, bool kVec>
__device__ __forceinline__ void load_cols(
    const __nv_bfloat16* __restrict__ src, int nf, float (&v)[C]) {
  if constexpr (kVec) {
#pragma unroll
    for (int j = 0; j < C / 4; ++j) {
      uint2 t = make_uint2(0u, 0u);
      if (4 * j < nf) t = __ldg(reinterpret_cast<const uint2*>(src) + j);
      v[4 * j] = __uint_as_float(t.x << 16);
      v[4 * j + 1] = __uint_as_float(t.x & 0xffff0000u);
      v[4 * j + 2] = __uint_as_float(t.y << 16);
      v[4 * j + 3] = __uint_as_float(t.y & 0xffff0000u);
    }
  } else {
    const unsigned short* u = reinterpret_cast<const unsigned short*>(src);
#pragma unroll
    for (int i = 0; i < C; ++i)
      v[i] = i < nf
                 ? __uint_as_float(static_cast<unsigned>(__ldg(u + i)) << 16)
                 : 0.f;
  }
}

// x rounded to the nearest bf16 (ties to even), as an f32: the one-limb
// kernels' rounding of a logit operand or a message before its sum.
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int C, bool kVec>
__device__ __forceinline__ void store_cols(float* dst, int nf,
                                           const float (&v)[C]) {
  if constexpr (kVec) {
#pragma unroll
    for (int j = 0; j < C / 4; ++j)
      if (4 * j < nf)
        reinterpret_cast<float4*>(dst)[j] =
            make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < C; ++i)
      if (i < nf) dst[i] = v[i];
  }
}

// out[tile] += part[e], part[e + 1], ... for the extra pieces of each split
// tile, in order, over [128, L] rows; the blocks of a tile's first extra
// piece do the tile, the others return. A tile's pieces end at the first
// cut at or past its end; their loads go PIECE_BATCH at a time, so that a
// tile of many pieces (a hub's: some 35) does not wait one load latency
// per piece, and the adds keep piece order (the same bits).
__global__ void __launch_bounds__(PIECE_THREADS)
tile_combine_kernel(const int* __restrict__ tile_ptr, int n_tiles,
                    const int* __restrict__ split_at, int n_split, int L,
                    const float* __restrict__ part, float* __restrict__ out) {
  const int e = blockIdx.x;
  const int tile = lower_bound(tile_ptr, n_tiles + 1, split_at[e] + 1) - 1;
  if (e > 0 && split_at[e - 1] > tile_ptr[tile]) return;
  const int f_end = lower_bound(split_at, n_split, tile_ptr[tile + 1]);
  const long long n = static_cast<long long>(TILE) * L;
  const long long i = static_cast<long long>(blockIdx.y) * PIECE_THREADS +
                      threadIdx.x;
  if (i >= n) return;
  float* o = out + tile * n + i;
  const float* src = part + i;
  float s = *o;
  for (int f = e; f < f_end; f += PIECE_BATCH) {
    float v[PIECE_BATCH];
#pragma unroll
    for (int u = 0; u < PIECE_BATCH; ++u)
      v[u] = f + u < f_end ? src[(f + u) * n] : 0.f;
#pragma unroll
    for (int u = 0; u < PIECE_BATCH; ++u)
      if (f + u < f_end) s += v[u];
  }
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
