// Tile-owner segment sum for Hopper (sm_90a), the body of stream_scatter.cu
// and banded_sender_sum.cu.
//
// Same function as the Pallas TPU kernels pygat_tpu/ops/stream.py::
// _make_kernel (launched by stream_scatter) and pygat_tpu/ops/banded.py::
// _make_sender_sum_kernel (launched by _banded_sender_sum_direct): rows of
// edge data [E, L] are summed into the node rows [N_pad, L] their slots
// name; dead slots add nothing, and a row that no live slot names is 0.
//
// Both kernels run over a walk (ops/stream.py StreamWalk): an order of
// positions in which each 128-row output tile owns the chunks of 256
// positions [tile_ptr[t], tile_ptr[t + 1]) and its positions are sorted by
// output row, so that row l of tile t is the run of positions row_ptr[key]
// .. row_ptr[key + 1] - 1, key = t * 129 + l (key t * 129 + 128 starts the
// tile's dead positions, which are never read). Position k reads the data
// row rows[k], or row k itself when rows is null. The walks:
//   * the receiver stream (Graph.stream_walk): its own walk, data row k;
//   * the graph's CSC stream (Graph.sender_walk): its own walk; data row
//     c_slot[k] (edge data in the graph's edge order), or k (the corner
//     path's data, already in CSC order); the dummy sender's run holds the
//     receiver stream's padding slots, which the JAX kernel sums too;
//   * a band plan's receiver side (BandPlan.spmm_walk): data row order[k],
//     the banded slot at position k;
//   * a band plan's sender side (BandPlan.sender_walk): a stream over its
//     live banded slots only, sender-sorted; data row its banded slot. The
//     plan's dead slots (some 1.05M at 524k) are in no run.
//
// The TPU kernels scatter with one-hot matmuls on the MXU (Mosaic cannot
// gather or scatter rows) and walk the chunks in order, keeping a tile
// resident while its chunks add into it. Here:
//   * a block owns one output tile's chunk range and a slab of at most 256
//     columns (grid.y); a unit of P lanes owns one tile row, a lane C <= 8
//     consecutive columns, P = pow2 >= ceil(width / 8) (at most 32). So at
//     L = 1 a lane owns a row and a warp sums 32 rows; at L = 64 a row
//     takes 8 lanes of 8 columns (two float4 loads each);
//   * the unit walks its row's run, TS_BATCH positions at a time (their
//     row words, then their data rows, all in flight before the first add;
//     float4 loads where C and L are multiples of 4 and the arrays 16-byte
//     aligned), sums in registers in position order and stores the row
//     once. Every row of the tile is stored, zeros included: no memset, no
//     atomic, and the same bits from call to call;
//   * a run longer than TS_SPLIT positions (a hub's row, or the dummy
//     sender's) would leave its unit walking while the others idle: such
//     runs are cut into segments, which all the block's units walk, one
//     segment each a round, into partial sums in shared memory that the
//     row's own unit adds in segment order: segments of TS_SEG positions
//     (two batches), longer where that would leave a run more segments
//     than the block has units, so that a run takes one round. This is a
//     second instantiation (kSplit), launched only for a walk whose
//     longest run (max_run) exceeds TS_SPLIT;
//   * a tile that the host cuts (split_at) is walked as pieces, each
//     clipping its rows' runs to its chunk range and storing into part,
//     then added into out in order (tile_pieces.cuh);
//   * a block holds 128 / B rows (at most 256 threads; 128 in kSplit, whose
//     blocks wait at barriers: 2-30 % faster there, where elsewhere such
//     blocks gained nothing), and a grid of fewer than two blocks per SM
//     doubles B down to one warp a block.
// pygat_tpu_torch/tools/spmm_ab.py times both kernels against another
// checkout's, and their time by altered copies of this body (--ablate).
//
// The data rows are f32, or bf16 in the one-limb instantiations
// (stream_scatter_bf16.cu, banded_sender_sum_bf16.cu: the TPU kernels at
// two_limb=False / exact=False, which round the data to bf16 before the
// one-hot matmul that sums it): each bf16 value widens to
// its f32 exactly and is summed in f32, so the sums are those of the
// rounded data in the walk's order.
//
// Bound on the H100: bytes: the data rows of the live slots once (4 bytes
// a value, 2 in bf16), their index words, [N_pad, L] f32 written once; one
// add per value. The walk's row_ptr and tile ranges are the kernel's own
// layout and not counted.

#pragma once

#include <cstdint>

#include "tile_pieces.cuh"

namespace {

constexpr int TS_THREADS = 256;  // most threads a block
constexpr int TS_SPLIT_THREADS = 128;  // most threads a block of kSplit
constexpr int TS_BATCH = 4;      // positions a unit has in flight
constexpr int TS_MAX_C = 8;      // columns a lane covers
constexpr int TS_MAX_P = 32;     // lanes a unit
constexpr int TS_SPLIT = 32;     // longest run a unit walks alone
constexpr int TS_SEG = 8;        // positions of a long run's segment

template <class T>  // float, or __nv_bfloat16 (one limb)
struct SumArgsT {
  const T* data;       // [*, L]
  const int* rows;     // data row by walk position, or null: the position
  const int* row_ptr;  // [n_tiles * 129 + 1] first position of each key
  const int* tile_ptr;
  const int* split_at;
  int n_tiles, n_split, L;
  float* out;   // [n_tiles * 128, L]
  float* part;  // [n_split, 128, L]
  int P;        // lanes a unit
};
using SumArgs = SumArgsT<float>;

// Adds the data rows of walk positions [lo, hi) into acc (this lane's
// columns col .. col + nf - 1), in position order; the unit's lanes call it
// together.
template <int C, bool kVec, class T>
__device__ __forceinline__ void sum_run(const SumArgsT<T>& p, int col, int nf,
                                        int lo, int hi, float (&acc)[C]) {
  for (int k0 = lo; k0 < hi; k0 += TS_BATCH) {
    const int n = min(TS_BATCH, hi - k0);  // the same for the unit
    int r[TS_BATCH];
#pragma unroll
    for (int u = 0; u < TS_BATCH; ++u)
      r[u] = u < n ? (p.rows ? __ldg(p.rows + k0 + u) : k0 + u) : 0;
    float v[TS_BATCH][C];
#pragma unroll
    for (int u = 0; u < TS_BATCH; ++u)
      load_cols<C, kVec>(p.data + static_cast<long long>(r[u]) * p.L + col,
                         u < n ? nf : 0, v[u]);
#pragma unroll
    for (int u = 0; u < TS_BATCH; ++u) {
      if (u < n) {
#pragma unroll
        for (int i = 0; i < C; ++i) acc[i] += v[u][i];
      }
    }
  }
}

// gridDim = (n_tiles + n_split, column slabs, B); blockDim = 128 / B units
// of P lanes. kSplit: runs longer than TS_SPLIT positions may occur (the
// walk's max_run says so), and are cut into segments.
template <int C, bool kVec, bool kSplit, class T>
__global__ void __launch_bounds__(kSplit ? TS_SPLIT_THREADS : TS_THREADS)
    tile_sum_kernel(const SumArgsT<T> p) {
  const int P = p.P;
  const int units = blockDim.x / P;
  const int unit = threadIdx.x / P;
  const int lu = threadIdx.x & (P - 1);
  const int col = blockIdx.y * P * C + lu * C;
  const int nf = max(0, min(C, p.L - col));

  // the block's chunk range (tile_pieces.cuh) and the unit's row's run
  // within it
  const TileRange tr =
      tile_range(blockIdx.x, p.tile_ptr, p.split_at, p.n_tiles, p.n_split);
  const int l = blockIdx.z * units + unit;
  const int key = tr.tile * (TILE + 1) + l;
  const int lo = max(__ldg(p.row_ptr + key), tr.c_lo * EC);
  const int hi = min(__ldg(p.row_ptr + key + 1), tr.c_hi * EC);

  float acc[C];
#pragma unroll
  for (int i = 0; i < C; ++i) acc[i] = 0.f;
  const bool heavy = kSplit && hi - lo > TS_SPLIT;
  if (lo < hi && !heavy) sum_run<C, kVec>(p, col, nf, lo, hi, acc);

  if constexpr (kSplit) {
    // the long runs are cut into segments, which all the block's units
    // walk, a round of one segment each at a time; the long row's own unit
    // adds their partial sums in segment order. A run's segments are of
    // TS_SEG positions, or longer where the run has more than the block's
    // units have segments
    __shared__ int s_first[TILE + 1];  // a row's first segment
    __shared__ int s_lo[TILE], s_hi[TILE], s_len[TILE];
    __shared__ float s_part[TS_SPLIT_THREADS * C];  // a round's sums
    if (__syncthreads_or(heavy)) {  // the same for the block
      if (lu == 0) {
        const int len = max(TS_SEG, (hi - lo + units - 1) / units);
        s_first[unit] = heavy ? (hi - lo + len - 1) / len : 0;
        s_lo[unit] = lo;
        s_hi[unit] = hi;
        s_len[unit] = len;
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        int sum = 0;
        for (int u = 0; u < units; ++u) {
          const int n = s_first[u];
          s_first[u] = sum;
          sum += n;
        }
        s_first[units] = sum;
      }
      __syncthreads();
      const int n_seg = s_first[units];
      for (int base = 0; base < n_seg; base += units) {
        const int g = base + unit;
        float pa[C];
#pragma unroll
        for (int i = 0; i < C; ++i) pa[i] = 0.f;
        if (g < n_seg) {
          // the row whose segments hold g: the last one starting at or
          // before it
          const int j = lower_bound(s_first, units + 1, g + 1) - 1;
          const int seg = s_lo[j] + (g - s_first[j]) * s_len[j];
          sum_run<C, kVec>(p, col, nf, seg, min(seg + s_len[j], s_hi[j]),
                           pa);
        }
        float* mine = s_part + threadIdx.x * C;
#pragma unroll
        for (int i = 0; i < C; ++i) mine[i] = pa[i];
        __syncthreads();
        if (heavy) {
          const int e = min(base + units, s_first[unit + 1]);
#pragma unroll 4
          for (int g2 = max(base, s_first[unit]); g2 < e; ++g2) {
            const float* src = s_part + ((g2 - base) * P + lu) * C;
#pragma unroll
            for (int i = 0; i < C; ++i) acc[i] += src[i];
          }
        }
        __syncthreads();
      }
    }
  }

  // the row, once: the tile's first piece into out, another into its part
  const long long row =
      tr.piece < 0 ? static_cast<long long>(tr.tile) * TILE + l
                   : static_cast<long long>(tr.piece) * TILE + l;
  store_cols<C, kVec>((tr.piece < 0 ? p.out : p.part) + row * p.L + col, nf,
                      acc);
}

template <int C, bool kVec, class T>
void launch_sum_split(const SumArgsT<T>& p, bool split, dim3 grid,
                      int threads, cudaStream_t st) {
  if (split)
    tile_sum_kernel<C, kVec, true, T><<<grid, threads, 0, st>>>(p);
  else
    tile_sum_kernel<C, kVec, false, T><<<grid, threads, 0, st>>>(p);
}

template <int C, class T>
int launch_sum_c(const SumArgsT<T>& p, bool vec, bool split, dim3 grid,
                 int threads, cudaStream_t st) {
  if constexpr (C % 4 == 0) {
    if (vec) {
      launch_sum_split<C, true>(p, split, grid, threads, st);
      return static_cast<int>(cudaGetLastError());
    }
  }
  launch_sum_split<C, false>(p, split, grid, threads, st);
  return static_cast<int>(cudaGetLastError());
}

// Launches the segment sum over the walk on `stream` (cutting runs into
// segments when the walk's longest run, max_run, exceeds TS_SPLIT), then,
// if any tile is split, adds the pieces into out. Returns the first CUDA
// error, or cudaGetLastError() after the launches.
template <class T>
int launch_tile_sum(SumArgsT<T> p, int max_run, void* stream) {
  if (p.n_tiles <= 0 || p.L <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int width = p.L < TS_MAX_P * TS_MAX_C ? p.L : TS_MAX_P * TS_MAX_C;
  p.P = 1;
  while (p.P * TS_MAX_C < width) p.P <<= 1;
  const int C = (width + p.P - 1) / p.P;
  const auto aligned = [](const void* q) {
    return q == nullptr || reinterpret_cast<std::uintptr_t>(q) % 16 == 0;
  };
  const bool vec = C % 4 == 0 && p.L % 4 == 0 && aligned(p.data) &&
                   aligned(p.out) && aligned(p.part);

  const bool split = max_run > TS_SPLIT;
  dim3 grid(p.n_tiles + p.n_split, (p.L + p.P * C - 1) / (p.P * C), 1);
  while (TILE / grid.z * p.P > (split ? TS_SPLIT_THREADS : TS_THREADS))
    grid.z *= 2;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  // a grid of fewer than two blocks an SM: smaller blocks, more of them
  while (2LL * sms > 1LL * grid.x * grid.y * grid.z &&
         TILE / grid.z * p.P > 32)
    grid.z *= 2;
  const int threads = TILE / grid.z * p.P;

  int rc = 0;
  switch (C) {
    case 1: rc = launch_sum_c<1>(p, vec, split, grid, threads, st); break;
    case 2: rc = launch_sum_c<2>(p, vec, split, grid, threads, st); break;
    case 3: rc = launch_sum_c<3>(p, vec, split, grid, threads, st); break;
    case 4: rc = launch_sum_c<4>(p, vec, split, grid, threads, st); break;
    case 5: rc = launch_sum_c<5>(p, vec, split, grid, threads, st); break;
    case 6: rc = launch_sum_c<6>(p, vec, split, grid, threads, st); break;
    case 7: rc = launch_sum_c<7>(p, vec, split, grid, threads, st); break;
    default: rc = launch_sum_c<8>(p, vec, split, grid, threads, st); break;
  }
  if (rc != 0) return rc;
  return launch_tile_combine(p.tile_ptr, p.n_tiles, p.split_at, p.n_split,
                             p.L, p.part, p.out, st);
}

}  // namespace
