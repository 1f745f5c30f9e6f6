// Stream segment sum of bf16 data for Hopper (sm_90a): the one-limb
// instantiation of stream_scatter.cu.
//
// Replaces the Pallas TPU kernel pygat_tpu/ops/stream.py::_make_kernel at
// two_limb=False (precision="fastest"), whose producer rounds the edge data
// to bf16 (to nearest, ties to even) and whose one-hot matmuls add the
// rounded values in f32. Here the wrapper (ops/stream.py stream_scatter)
// makes that bf16 copy, and the tile-owner body tile_sum.cuh reads it: 2
// bytes a value where stream_scatter.cu reads 4, each widened to its f32
// exactly and summed in f32 in the walk's order. Same layout, walks,
// split runs and split tiles as stream_scatter.cu.

#include "tile_sum.cuh"

// data [*, L] bf16; rows, row_ptr, tile_ptr, split_at, n_tiles, n_split,
// max_run, L, out [n_tiles * 128, L] f32 and part [n_split, 128, L] f32 as
// in stream_scatter.cu. Launches on `stream`; returns the first CUDA error,
// or cudaGetLastError() after the launches.
extern "C" int pygat_stream_scatter_bf16(const __nv_bfloat16* data,
                                         const int* rows, const int* row_ptr,
                                         const int* tile_ptr,
                                         const int* split_at, int n_tiles,
                                         int n_split, int max_run, int L,
                                         float* out, float* part,
                                         void* stream) {
  return launch_tile_sum(
      SumArgsT<__nv_bfloat16>{data, rows, row_ptr, tile_ptr, split_at,
                              n_tiles, n_split, L, out, part, 0},
      max_run, stream);
}
