// How a slot of a chunked edge order finds its node row, and the row
// gather built on it (shared by expand.cu, banded_take.cu,
// banded_sender_sum.cu, corner_permute.cu, the segment sums of
// stream_scatter.cuh and the SpMM body of tile_spmm.cuh; the fused
// attention kernels' tile_fused.cuh takes EC and TILE from here and has
// walk policies of its own).
//
// Every edge order of the port is cut into chunks of EC = 256 slots. A slot
// names a node row in one of four ways:
//   * ListedRows: row rows[k], one index word per slot (a slot map, a
//     band plan's walk);
//   * WindowRows: row base[c] * 128 + loc[k] for slot k of chunk c, where
//     loc[k] outside [0, limit) marks a dead slot. The expand kernel reads
//     the receiver side this way (base = chunk_tile, loc = local, limit =
//     128), the banded kernels the sender side (base = band, loc = s_loc,
//     limit = w * 128), and a corner-turn pass its input rows with 128-row
//     blocks (base = lo, loc = g, limit = p * 128; the plan never marks a
//     row dead). The dead test comes before the row is formed: a dead slot
//     of a chunk whose window is the last one would name row N_pad, one
//     past the table;
//   * PanelRows: row panel_tiles[chunk_tile[c] * p + g[k] / 128] * 128 +
//     g[k] % 128, where g[k] outside [0, p * 128) marks a slot that is dead
//     or overflows its output tile's p panels (the panel SpMM). g is tested
//     before a row is formed: the padded columns of panel_tiles hold tile 0;
//   * SlotRows: row k itself, for slot k: the stream segment sum reads
//     receiver-stream data.
// WindowRows and PanelRows return -1 for a dead slot. ListedRows and
// SlotRows never do: the receiver stream's padding slots name the dummy row
// N_pad - 1 and are told dead by their local row.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int EC = 256;    // slots per chunk
constexpr int TILE = 128;  // rows per output tile / window tile

// ListedRows, WindowRows and PanelRows also split the lookup into word(k),
// the slot's own index word, and row(word, chunk), so that a caller can
// load the words of a later chunk early.
struct ListedRows {
  const int* rows;
  __device__ int word(long long k) const { return rows[k]; }
  __device__ int row(int r, int) const { return r; }
  __device__ int operator()(long long k, int) const { return rows[k]; }
};

struct WindowRows {
  const int* base;
  const int* loc;
  int limit;
  __device__ int word(long long k) const { return loc[k]; }
  __device__ int row(int l, int chunk) const {
    return static_cast<unsigned>(l) < static_cast<unsigned>(limit)
               ? base[chunk] * TILE + l
               : -1;
  }
  __device__ int operator()(long long k, int chunk) const {
    return row(word(k), chunk);
  }
};

struct PanelRows {
  const int* panel_tiles;  // [n_tiles, p]
  const int* chunk_tile;
  const int* g;
  int p;
  __device__ int word(long long k) const { return g[k]; }
  __device__ int row(int gk, int chunk) const {
    if (static_cast<unsigned>(gk) >= static_cast<unsigned>(p * TILE))
      return -1;
    const long long at = static_cast<long long>(chunk_tile[chunk]) * p +
                         gk / TILE;
    return panel_tiles[at] * TILE + gk % TILE;
  }
  __device__ int operator()(long long k, int chunk) const {
    return row(word(k), chunk);
  }
};

struct SlotRows {
  __device__ int operator()(long long k, int) const {
    return static_cast<int>(k);
  }
};

// out[k, :] = table[rows(k), :], zeros at dead slots; one block of ROWS
// threads per ROWS output rows (a 256-slot chunk, or a 128-row tile of a
// corner-turn pass, whose tile count may be odd), block b passing b as the
// chunk to the row policy. Each thread writes the elements i, i + ROWS, ...
// of the block's [ROWS, L] output, so the stores are coalesced and a row's
// L floats are read by neighbouring threads. Offsets are 64-bit: E * L
// passes 2^31 at 1M nodes.
template <int ROWS, class Rows>
__global__ void __launch_bounds__(ROWS)
gather_rows_kernel(const float* __restrict__ table, Rows rows, int L,
                   float* __restrict__ out) {
  __shared__ int s_row[ROWS];
  const long long k0 = static_cast<long long>(blockIdx.x) * ROWS;
  s_row[threadIdx.x] = rows(k0 + threadIdx.x, blockIdx.x);
  __syncthreads();
  float* o = out + k0 * L;
  const int n = ROWS * L;
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += ROWS) {
    const int k = i / L;
    const int r = s_row[k];
    o[i] = r >= 0 ? __ldg(table + static_cast<long long>(r) * L + (i - k * L))
                  : 0.f;
  }
}

// n_blocks blocks of ROWS rows (EC: one per chunk).
template <int ROWS = EC, class Rows>
int launch_gather_rows(const float* table, Rows rows, int n_blocks, int L,
                       float* out, void* stream) {
  if (n_blocks <= 0 || L <= 0) return 0;
  gather_rows_kernel<ROWS, Rows><<<n_blocks, ROWS, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      table, rows, L, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
