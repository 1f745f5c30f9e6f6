// Fused GATv1 attention forward over a band plan from a bf16 sender table,
// for Hopper (sm_90a): the one-limb instantiation of fused_v1_banded.cu.
//
// Replaces the Pallas TPU kernel pygat_tpu/ops/banded.py::
// _make_v1_banded_kernel at two_limb=False (launched by _banded_grid_call
// under precision="fastest"), which selects each chunk's sender rows from
// a bf16 window, forms the logit from them and a bf16 a_src, and adds each
// message rounded to bf16 into f32: the rounding points of the stream's
// one-limb kernel (fused_v1_bf16.cu). Here the wrapper (ops/banded.py
// fused_v1_banded) casts wh to bf16 once a call, and the tile-owner body
// tile_fused.cuh walks the plan's walk as fused_v1_banded.cu does,
// gathering the sender rows at 2 bytes a value (tile_fused.cuh describes
// the kernel, its rounding and what bounds it).

#include "tile_fused.cuh"

// wh [N, H*F] bf16; f_dst, bound, a_src (f32, rounded to bf16 in the
// kernel), keepq, rows, order, row_ptr, tile_ptr, split_at, n_tiles,
// n_split, max_run, H, F, alpha, out, den, part_out, part_den as in
// fused_v1_banded.cu. Launches on `stream`; returns the first CUDA error,
// or cudaGetLastError() after the launches (cudaErrorInvalidValue when
// F > 256).
extern "C" int pygat_fused_v1_banded_bf16(
    const __nv_bfloat16* wh, const float* f_dst, const float* bound,
    const float* a_src, const float* keepq, const int* rows,
    const int* order, const int* row_ptr, const int* tile_ptr,
    const int* split_at, int n_tiles, int n_split, int max_run, int H, int F,
    float alpha, float* out, float* den, float* part_out, float* part_den,
    void* stream) {
  const int hf = H * F;
  return launch_tile_fused<false>(
      FusedArgsT<__nv_bfloat16>{wh, nullptr, hf, nullptr, f_dst, bound,
                                a_src, keepq, row_ptr, tile_ptr, split_at,
                                n_tiles, n_split, H, F, alpha, out, den,
                                part_out, part_den, 0, 0, 0},
      BandWalk{rows, order}, max_run, stream);
}
