// Fused GATv2 attention forward over the receiver stream with a pre-built
// bf16 [whj | whi] sender window, for Hopper (sm_90a): the one-limb
// instantiation of fused_v2_window.cu, the corner path's forward under
// "fastest".
//
// Replaces the Pallas TPU kernel pygat_tpu/ops/fused_stream.py::
// _make_v2_kernel at two_limb=False as pygat_tpu/ops/fused_corner.py
// launches it under precision="fastest": over the [gj | gi] windows that
// the CSC expand and the corner-turn passes built in f32 and then cast to
// bf16, adding whj[s] to the receiver's f32 whi[r], rounding the
// LeakyReLU'd sum and a to bf16 for the logit, and adding each message
// whi[s] * num * keepq rounded to bf16 into f32. Here the wrapper
// (ops/fused_corner.py fused_v2_window) casts the window to bf16 once a
// call, and the tile-owner body tile_fused.cuh reads slot k's sender-side
// rows from columns [0, HF) (whj) and [HF, 2HF) (whi) of row k of it
// (SlotWalk, row stride 2HF) at 2 bytes a value, rounding as
// fused_v2_bf16.cu does (tile_fused.cuh describes the kernel, its rounding
// and what bounds it).

#include "tile_fused.cuh"

// whi [N, H*F] f32 (the receiver's rows); win [E_s, 2*H*F] bf16 (row k:
// [whj | whi] at slot k's sender); ub, a (f32, rounded to bf16 in the
// kernel), keepq, row_ptr, tile_ptr, split_at, n_tiles, n_split, max_run,
// H, F, alpha, out, den, part_out, part_den as in fused_v2_window.cu.
// Launches on `stream`; returns the first CUDA error, or
// cudaGetLastError() after the launches (cudaErrorInvalidValue when
// F > 256).
extern "C" int pygat_fused_v2_window_bf16(
    const float* whi, const __nv_bfloat16* win, const float* ub,
    const float* a, const float* keepq, const int* row_ptr,
    const int* tile_ptr, const int* split_at, int n_tiles, int n_split,
    int max_run, int H, int F, float alpha, float* out, float* den,
    float* part_out, float* part_den, void* stream) {
  const int hf = H * F;
  return launch_tile_fused<true>(
      FusedArgsT<__nv_bfloat16>{win, win + hf, 2 * hf, whi, nullptr, ub, a,
                                keepq, row_ptr, tile_ptr, split_at, n_tiles,
                                n_split, H, F, alpha, out, den, part_out,
                                part_den, 0, 0, 0},
      SlotWalk{}, max_run, stream);
}
