// Fused GATv2 attention forward over the receiver stream from bf16 sender
// tables, for Hopper (sm_90a): the one-limb instantiation of fused_v2.cu.
//
// Replaces the Pallas TPU kernel pygat_tpu/ops/fused_stream.py::
// _make_v2_kernel at two_limb=False (precision="fastest"), which receives
// whj and whi at the senders as bf16 windows (the combined and split
// window modes give the same values), adds whj[s] to the receiver's f32
// whi[r], rounds the LeakyReLU'd sum and a to bf16 for the logit, and adds
// each message whi[s] * num * keepq rounded to bf16 into f32. Here the
// wrapper (ops/fused_stream.py fused_v2) casts whj and whi to bf16 once a
// call, and the tile-owner body tile_fused.cuh gathers their rows (2 bytes
// a value) and rounds at the same points (tile_fused.cuh describes the
// kernel and what bounds it).

#include "tile_fused.cuh"

// whi [n_tiles * 128, H*F] f32 (the receiver's rows); whi_s and whj
// [N_s, H*F] bf16 (the sender's rows: the message and the logit's); ub, a
// (f32, rounded to bf16 in the kernel), keepq, senders, row_ptr, tile_ptr,
// split_at, n_tiles, n_split, max_run, H, F, alpha, out, den, part_out,
// part_den as in fused_v2.cu (a hop of the ring passes its sender buffers'
// bf16 copies). Launches on `stream`; returns the first CUDA error, or
// cudaGetLastError() after the launches (cudaErrorInvalidValue when
// F > 256).
extern "C" int pygat_fused_v2_bf16(
    const float* whi, const __nv_bfloat16* whi_s, const __nv_bfloat16* whj,
    const float* ub, const float* a, const float* keepq, const int* senders,
    const int* row_ptr, const int* tile_ptr, const int* split_at,
    int n_tiles, int n_split, int max_run, int H, int F, float alpha,
    float* out, float* den, float* part_out, float* part_den, void* stream) {
  const int hf = H * F;
  return launch_tile_fused<true>(
      FusedArgsT<__nv_bfloat16>{whj, whi_s, hf, whi, nullptr, ub, a, keepq,
                                row_ptr, tile_ptr, split_at, n_tiles,
                                n_split, H, F, alpha, out, den, part_out,
                                part_den, 0, 0, 0},
      ListWalk{senders}, max_run, stream);
}
