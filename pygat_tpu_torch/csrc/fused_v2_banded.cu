// Fused GATv2 attention forward over a band plan, for Hopper (sm_90a).
// Replaces the Pallas TPU kernel pygat_tpu/ops/banded.py::
// _make_v2_banded_kernel (launched by _banded_grid_call), which selects
// each chunk's sender [whj | whi] rows from its w-tile VMEM window with
// one-hot matmuls. Here a block owns a receiver tile and walks its slots in
// the plan's walk, receivers ascending, keeping the receiver's whi row in
// registers for its run, summing the run in registers and storing every
// row once (tile_fused.cuh, which describes the kernel and what bounds
// it).
// One 524k-node forward of the Cora preset (H 8 F 8, then H 1 F 4) takes
// 0.68 ms against 7.37 ms for the first port's block-per-chunk body
// (pygat_tpu_torch/tools/banded_ab.py; NVIDIA H100 80GB HBM3, 700.00 W).

#include "tile_fused.cuh"

// whi / whj [N, H*F], ub [N, H], a [H, F], keepq [E_b, H] f32 (in the
// plan's banded slot order); rows, order [E_b] int32: the plan's walk by
// position, the sender row (-1 dead) and the banded slot; row_ptr
// [n_tiles * 129 + 1] int32: the first position of each (tile, local row)
// key t * 129 + l; tile_ptr [n_tiles + 1] and split_at [n_split] int32
// (ops/stream.py tile_ranges); max_run the most live slots of one receiver
// (the plan's max_run); out [n_tiles * 128, H*F] and den
// [n_tiles * 128, H] f32, every row written; part_out [n_split, 128, H*F]
// and part_den [n_split, 128, H] f32 scratch (unused when n_split is 0).
// Launches on `stream`; returns the first CUDA error, or
// cudaGetLastError() after the launches (cudaErrorInvalidValue when
// F > 256).
extern "C" int pygat_fused_v2_banded(
    const float* whi, const float* whj, const float* ub, const float* a,
    const float* keepq, const int* rows, const int* order,
    const int* row_ptr, const int* tile_ptr, const int* split_at,
    int n_tiles, int n_split, int max_run, int H, int F, float alpha,
    float* out, float* den, float* part_out, float* part_den, void* stream) {
  const int hf = H * F;
  return launch_tile_fused<true>(
      FusedArgs{whj, whi, hf, whi, nullptr, ub, a, keepq, row_ptr, tile_ptr,
                split_at, n_tiles, n_split, H, F, alpha, out, den, part_out,
                part_den, 0, 0, 0},
      BandWalk{rows, order}, max_run, stream);
}
