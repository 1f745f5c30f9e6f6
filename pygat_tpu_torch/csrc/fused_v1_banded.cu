// Fused GATv1 attention forward over a band plan's slot order, for Hopper
// (sm_90a). Replaces the Pallas TPU kernel pygat_tpu/ops/banded.py::
// _make_v1_banded_kernel (launched by _banded_grid_call); the kernel and
// what bounds it are described in fused_v1.cuh. Slot k of chunk c has the
// sender band[c] * 128 + s_loc[k] (s_loc == w * 128 marks a dead slot,
// whose local row is 128 too), where the TPU kernel selects the sender row
// from the chunk's w-tile VMEM window with one-hot matmuls.

#include "fused_v1.cuh"

// wh [N, H*F], f_dst / bound [N, H], a_src [H, F], keepq [E_b, H] f32;
// band [n_chunks] int32, s_loc / local [E_b] int32, chunk_tile [n_chunks]
// int32 (the plan's band, s_loc, r_local and r_chunk); out
// [n_tiles * 128, H*F] and den [n_tiles * 128, H] f32. Zeroes out and den
// and launches on `stream`; returns the first CUDA error, or
// cudaGetLastError() after the launch (cudaErrorInvalidValue when F > 256).
extern "C" int pygat_fused_v1_banded(const float* wh, const float* f_dst,
                                     const float* bound, const float* a_src,
                                     const float* keepq, const int* band,
                                     const int* s_loc, const int* local,
                                     const int* chunk_tile, int n_chunks,
                                     int n_tiles, int w, int H, int F,
                                     float alpha, float* out, float* den,
                                     void* stream) {
  return launch_fused_v1(wh, f_dst, bound, a_src, keepq,
                         WindowRows{band, s_loc, w * TILE}, local, chunk_tile,
                         n_chunks, n_tiles, H, F, alpha, out, den, stream);
}
