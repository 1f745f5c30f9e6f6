// Fused GATv1 attention forward over the receiver stream with a pre-built
// bf16 sender window, for Hopper (sm_90a): the one-limb instantiation of
// fused_v1_window.cu, the corner path's forward under "fastest".
//
// Replaces the Pallas TPU kernel pygat_tpu/ops/fused_stream.py::
// _make_v1_kernel at two_limb=False as pygat_tpu/ops/fused_corner.py
// launches it under precision="fastest": over the window that the CSC
// expand and the corner-turn passes built in f32 and then cast to bf16,
// forming the logit from its rows and a bf16 a_src, and adding each
// message rounded to bf16 into f32. Here the wrapper (ops/fused_corner.py
// fused_v1_window) casts the window to bf16 once a call, and the
// tile-owner body tile_fused.cuh reads slot k's sender row from row k of
// it (SlotWalk) at 2 bytes a value, rounding as fused_v1_bf16.cu does
// (tile_fused.cuh describes the kernel, its rounding and what bounds it).

#include "tile_fused.cuh"

// win [E_s, H*F] bf16 (row k: slot k's sender row of wh); f_dst, bound,
// a_src (f32, rounded to bf16 in the kernel), keepq, row_ptr, tile_ptr,
// split_at, n_tiles, n_split, max_run, H, F, alpha, out, den, part_out,
// part_den as in fused_v1_window.cu. Launches on `stream`; returns the
// first CUDA error, or cudaGetLastError() after the launches
// (cudaErrorInvalidValue when F > 256).
extern "C" int pygat_fused_v1_window_bf16(
    const __nv_bfloat16* win, const float* f_dst, const float* bound,
    const float* a_src, const float* keepq, const int* row_ptr,
    const int* tile_ptr, const int* split_at, int n_tiles, int n_split,
    int max_run, int H, int F, float alpha, float* out, float* den,
    float* part_out, float* part_den, void* stream) {
  const int hf = H * F;
  return launch_tile_fused<false>(
      FusedArgsT<__nv_bfloat16>{win, nullptr, hf, nullptr, f_dst, bound,
                                a_src, keepq, row_ptr, tile_ptr, split_at,
                                n_tiles, n_split, H, F, alpha, out, den,
                                part_out, part_den, 0, 0, 0},
      SlotWalk{}, max_run, stream);
}
