// How a slot of a chunked edge order finds its node row, and the row
// gather built on it (shared by expand.cu, banded_take.cu,
// banded_sender_sum.cu and the fused attention kernels).
//
// Every edge order of the port is cut into chunks of EC = 256 slots. A slot
// names a node row in one of two ways:
//   * ListedRows: row rows[k], one index word per slot (the receiver
//     stream's senders);
//   * WindowRows: row base[c] * 128 + loc[k] for slot k of chunk c, where
//     loc[k] outside [0, limit) marks a dead slot. The expand kernel reads
//     the receiver side this way (base = chunk_tile, loc = local, limit =
//     128), the banded kernels the sender side (base = band, loc = s_loc,
//     limit = w * 128). The dead test comes before the row is formed: a
//     dead slot of a chunk whose window is the last one would name row
//     N_pad, one past the table.
// Both return -1 for a dead slot (ListedRows has none: the receiver
// stream's padding slots name the dummy row N_pad - 1 and are told dead by
// their local row).

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int EC = 256;    // slots per chunk
constexpr int TILE = 128;  // rows per output tile / window tile

struct ListedRows {
  const int* rows;
  __device__ int operator()(long long k, int) const { return rows[k]; }
};

struct WindowRows {
  const int* base;
  const int* loc;
  int limit;
  __device__ int operator()(long long k, int chunk) const {
    const int l = loc[k];
    return static_cast<unsigned>(l) < static_cast<unsigned>(limit)
               ? base[chunk] * TILE + l
               : -1;
  }
};

constexpr int GATHER_THREADS = EC;  // one thread stages each slot's row

// out[k, :] = table[rows(k), :], zeros at dead slots; one block per chunk.
// Each thread writes the elements i, i + 256, ... of the chunk's [EC, L]
// output block, so the stores are coalesced and a row's L floats are read
// by neighbouring threads. Offsets are 64-bit: E * L passes 2^31 at 1M
// nodes.
template <class Rows>
__global__ void __launch_bounds__(GATHER_THREADS)
gather_rows_kernel(const float* __restrict__ table, Rows rows, int L,
                   float* __restrict__ out) {
  __shared__ int s_row[EC];
  const long long k0 = static_cast<long long>(blockIdx.x) * EC;
  s_row[threadIdx.x] = rows(k0 + threadIdx.x, blockIdx.x);
  __syncthreads();
  float* o = out + k0 * L;
  const int n = EC * L;
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += GATHER_THREADS) {
    const int k = i / L;
    const int r = s_row[k];
    o[i] = r >= 0 ? __ldg(table + static_cast<long long>(r) * L + (i - k * L))
                  : 0.f;
  }
}

template <class Rows>
int launch_gather_rows(const float* table, Rows rows, int n_chunks, int L,
                       float* out, void* stream) {
  if (n_chunks <= 0 || L <= 0) return 0;
  gather_rows_kernel<Rows><<<n_chunks, GATHER_THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(table, rows,
                                                                  L, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
