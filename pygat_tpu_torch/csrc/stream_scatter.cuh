// Stream segment sum for Hopper (sm_90a), templated on where a slot's row
// comes from (the body of stream_scatter.cu).
//
// The stream is cut into chunks of EC = 256 slots; chunk c adds only into
// the 128-row output tile chunk_tile[c] (non-decreasing), slot k adds into
// row local[k] of that tile, and local == TILE (128) marks a dead slot that
// contributes nothing. Slot k's data row is data[rows(k, c)] (slot_rows.cuh:
// SlotRows for row k itself, ListedRows for a slot map; a row of -1 marks
// a dead slot as well).
//
// The TPU kernels scatter with a one-hot matmul on the MXU and split f32
// into bf16 limbs, because Mosaic cannot gather or scatter rows; their grid
// walks the chunks in order and keeps a tile resident while consecutive
// chunks add into it. Here the chunks run in parallel, one thread block per
// chunk (and per 64 columns), and rows are read natively:
//   * the block stages the chunk's local rows and source rows in shared
//     memory with one coalesced load, then all threads copy the chunk's
//     live data rows into a [256, cols] shared window, several independent
//     loads in flight per thread (on the sender side these are random rows
//     of an array that need not fit in L2);
//   * threads form groups of `cols` (one thread per column); each group
//     walks a contiguous slice of the window, sums runs of equal local rows
//     in a register (the receiver stream is sorted by row; the banded order
//     is sorted by sender within a tile, so its runs are short) and adds
//     each run into an f32 [128, cols] accumulator in shared memory with one
//     atomic;
//   * the block adds the rows its chunk touched into the output with one
//     global atomic per element; the launcher zeroes the output first, so
//     every row is written, also in a tile with no live slot.
// One block per chunk, not per tile: tiles own very different chunk counts
// on the sender side (every padding edge has the dummy sender N_pad - 1, so
// the last tile owns 23 of Cora's 128 CSC chunks and 86 of Pubmed's 856),
// and a block per tile left the whole call waiting on that one block. (The
// SpMM kernels, whose receiver-ordered tiles own even chunk counts, left
// this body for the tile-owner one of tile_spmm.cuh: measured in the
// comments of spmm_banded.cu and panel_spmm.cu.)
// Accumulation is plain f32 (the reference's 'high' contract, no limbs);
// the atomics make the summation order vary from run to run.
//
// Bound on the H100: bytes. Each live slot reads L floats (plus its index
// words) and does one FLOP per float.

#pragma once

#include "slot_rows.cuh"

namespace {

constexpr int SCATTER_THREADS = 512;
constexpr int MAX_SLAB = 64;  // columns per block
constexpr int UNROLL = 8;     // independent window loads per thread

template <class Rows>
__global__ void __launch_bounds__(SCATTER_THREADS)
scatter_rows_kernel(const float* __restrict__ data, Rows rows,
                    const int* __restrict__ local,
                    const int* __restrict__ chunk_tile, int L,
                    float* __restrict__ out) {
  extern __shared__ float sm[];
  __shared__ int s_loc[EC];
  __shared__ int s_row[EC];
  __shared__ int s_lo, s_hi;  // range of local rows this chunk touches

  const long long base = static_cast<long long>(blockIdx.x) * EC;
  const int c0 = blockIdx.y * MAX_SLAB;
  const int cols = min(MAX_SLAB, L - c0);
  float* acc = sm;                // [TILE, cols]
  float* win = sm + TILE * cols;  // [EC, cols]: the chunk's data rows
  for (int i = threadIdx.x; i < TILE * cols; i += SCATTER_THREADS) acc[i] = 0.f;
  if (threadIdx.x == 0) {
    s_lo = TILE;
    s_hi = -1;
  }
  if (threadIdx.x < EC) {
    const long long k = base + threadIdx.x;
    // local[k] is read whatever the row: a load that depended on the row's
    // own load (a slot map) would wait for it
    const int loc = __ldg(local + k);
    const int row = rows(k, blockIdx.x);
    s_row[threadIdx.x] = row;
    s_loc[threadIdx.x] = row < 0 ? TILE : loc;
  }
  __syncthreads();
  if (threadIdx.x < EC && static_cast<unsigned>(s_loc[threadIdx.x]) < TILE) {
    atomicMin(&s_lo, s_loc[threadIdx.x]);
    atomicMax(&s_hi, s_loc[threadIdx.x]);
  }
  for (int i0 = threadIdx.x; i0 < EC * cols; i0 += SCATTER_THREADS * UNROLL) {
    float v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * SCATTER_THREADS;
      v[u] = 0.f;
      if (i < EC * cols) {
        const int k = i / cols;
        if (static_cast<unsigned>(s_loc[k]) < TILE) {
          v[u] = __ldg(data + static_cast<long long>(s_row[k]) * L + c0 +
                       (i - k * cols));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * SCATTER_THREADS;
      if (i < EC * cols) win[i] = v[u];
    }
  }
  __syncthreads();

  const int groups = SCATTER_THREADS / cols;
  const int grp = threadIdx.x / cols;
  const int col = threadIdx.x - grp * cols;
  if (grp < groups) {
    const int per = (EC + groups - 1) / groups;
    const int k0 = grp * per;
    const int k1 = min(k0 + per, EC);
    int cur = -1;
    float sum = 0.f;
    for (int k = k0; k < k1; ++k) {
      const int loc = s_loc[k];
      if (static_cast<unsigned>(loc) >= TILE) continue;  // dead slot
      if (loc != cur) {
        if (cur >= 0) atomicAdd(&acc[cur * cols + col], sum);
        cur = loc;
        sum = 0.f;
      }
      sum += win[k * cols + col];
    }
    if (cur >= 0) atomicAdd(&acc[cur * cols + col], sum);
  }
  __syncthreads();

  float* o = out + static_cast<long long>(chunk_tile[blockIdx.x]) * TILE * L + c0;
  for (int i = s_lo * cols + threadIdx.x; i < (s_hi + 1) * cols;
       i += SCATTER_THREADS) {
    const int r = i / cols;
    atomicAdd(&o[static_cast<long long>(r) * L + (i - r * cols)], acc[i]);
  }
}

// Zeroes out [n_tiles * 128, L] and launches one block per chunk and per 64
// columns on `stream`; returns the first CUDA error, or cudaGetLastError()
// after the launch.
template <class Rows>
int launch_scatter_rows(const float* data, Rows rows,
                        const int* local, const int* chunk_tile, int n_chunks,
                        int n_tiles, int L, float* out, void* stream) {
  if (n_tiles <= 0 || L <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(
      out, 0, sizeof(float) * static_cast<size_t>(n_tiles) * TILE * L, st);
  if (e != cudaSuccess || n_chunks <= 0) return static_cast<int>(e);
  const int slab = L < MAX_SLAB ? L : MAX_SLAB;
  const size_t smem = sizeof(float) * (TILE + EC) * slab;
  // above 48 KB of shared memory, the static arrays' included, a kernel
  // must opt in. The attribute is set on the current device only, so it is
  // set at every such launch (a host-side call of about a microsecond).
  if (smem + sizeof(int) * (2 * EC + 2) > 48 * 1024) {
    e = cudaFuncSetAttribute(scatter_rows_kernel<Rows>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(n_chunks, (L + MAX_SLAB - 1) / MAX_SLAB);
  scatter_rows_kernel<Rows><<<grid, SCATTER_THREADS, smem, st>>>(
      data, rows, local, chunk_tile, L, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
