// Banded sender sum of bf16 data for Hopper (sm_90a): the one-limb
// instantiation of banded_sender_sum.cu.
//
// Replaces the Pallas TPU kernel pygat_tpu/ops/banded.py::
// _make_sender_sum_kernel at exact=False (launched by
// _banded_sender_sum_direct under precision="fastest"), which rounds each
// chunk's edge data to bf16 (to nearest, ties to even) and adds the
// rounded values in f32 with one one-hot matmul a window tile. Here the
// wrapper (ops/banded.py banded_sender_sum) makes that bf16 copy, and the
// tile-owner body tile_sum.cuh reads it over the plan's sender walk: 2
// bytes a value where banded_sender_sum.cu reads 4, each widened to its
// f32 exactly and summed in f32 in the walk's order. Same walk, split runs
// and split tiles as banded_sender_sum.cu.

#include "tile_sum.cuh"

// data [n_chunks * 256, L] bf16 in banded order; order, row_ptr, tile_ptr,
// split_at, n_tiles, n_split, max_run, L, out [n_tiles * 128, L] f32 and
// part [n_split, 128, L] f32 as in banded_sender_sum.cu. Launches on
// `stream`; returns the first CUDA error, or cudaGetLastError() after the
// launches.
extern "C" int pygat_banded_sender_sum_bf16(const __nv_bfloat16* data,
                                            const int* order,
                                            const int* row_ptr,
                                            const int* tile_ptr,
                                            const int* split_at, int n_tiles,
                                            int n_split, int max_run, int L,
                                            float* out, float* part,
                                            void* stream) {
  return launch_tile_sum(
      SumArgsT<__nv_bfloat16>{data, order, row_ptr, tile_ptr, split_at,
                              n_tiles, n_split, L, out, part, 0},
      max_run, stream);
}
