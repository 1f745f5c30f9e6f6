// Stream segment sum for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pygat_tpu/ops/stream.py::_make_kernel
// (launched by stream_scatter). It computes the same function: rows of
// edge data [E, L] are summed into [N_pad, L], where chunk c of 256 stream
// slots writes only the 128-row output tile chunk_tile[c], slot k adds into
// row local[k] of that tile, and local == 128 marks a dead slot; with a
// slot map (the sender side), slot k reads data row slot[k] instead of
// row k. The kernel runs on the tile-owner body tile_sum.cuh over a walk of
// the stream (the receiver stream's or the CSC stream's own, or a band
// plan's receiver walk), which notes its layout and what bounds it; at
// Cora's shapes the whole call moves a few MB, far below the launch
// latency, so Cora is launch-bound.

#include "tile_sum.cuh"

// data [*, L] f32; rows [positions] int32 (data row by walk position: the
// slot map, or the walk's order) or null (the position itself); row_ptr
// [n_tiles * 129 + 1], tile_ptr [n_tiles + 1], split_at [n_split] int32
// (the walk's); out [n_tiles * 128, L] f32; part [n_split, 128, L] f32 (or
// null when n_split is 0). Launches on `stream`; returns the first CUDA
// error, or cudaGetLastError() after the launches.
extern "C" int pygat_stream_scatter(const float* data, const int* rows,
                                    const int* row_ptr, const int* tile_ptr,
                                    const int* split_at, int n_tiles,
                                    int n_split, int max_run, int L,
                                    float* out, float* part, void* stream) {
  return launch_tile_sum(SumArgs{data, rows, row_ptr, tile_ptr, split_at,
                                 n_tiles, n_split, L, out, part, 0},
                         max_run, stream);
}
