// Stream segment sum for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pygat_tpu/ops/stream.py::_make_kernel
// (launched by stream_scatter). It computes the same function: rows of
// stream-ordered edge data [E_s, L] are summed into [N_pad, L], where chunk
// c of 256 slots writes only the 128-row output tile chunk_tile[c], slot k
// adds into row local[k] of that tile, and local == 128 marks a dead slot.
// With a slot map (the sender side), slot k reads data row slot[k] instead
// of row k; dead slots there point at edge 0 and are skipped by local
// alone. The device code, its layout and what bounds it are in
// stream_scatter.cuh; at Cora's shapes the whole call moves a few MB, far
// below the launch latency, so Cora is launch-bound.

#include "stream_scatter.cuh"

// data [E, L] f32 (E = E_s, or the edge count when slot is given);
// slot [E_s] int32 or null; local [E_s] int32; chunk_tile [n_chunks] int32;
// out [n_tiles * 128, L] f32. Zeroes out and launches on `stream`; returns
// the first CUDA error, or cudaGetLastError() after the launch.
extern "C" int pygat_stream_scatter(const float* data, const int* slot,
                                    const int* local, const int* chunk_tile,
                                    int n_chunks, int n_tiles, int L,
                                    float* out, void* stream) {
  if (slot)
    return launch_scatter_rows(data, ListedRows{slot}, Unweighted{}, local,
                               chunk_tile, n_chunks, n_tiles, L, out, stream);
  return launch_scatter_rows(data, SlotRows{}, Unweighted{}, local,
                             chunk_tile, n_chunks, n_tiles, L, out, stream);
}
