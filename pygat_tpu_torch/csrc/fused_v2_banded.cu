// Fused GATv2 attention forward over a band plan's slot order, for Hopper
// (sm_90a). Replaces the Pallas TPU kernel pygat_tpu/ops/banded.py::
// _make_v2_banded_kernel (launched by _banded_grid_call); the kernel and
// what bounds it are described in fused_v2.cuh. Slot k of chunk c has the
// sender band[c] * 128 + s_loc[k] (s_loc == w * 128 marks a dead slot,
// whose local row is 128 too), where the TPU kernel selects the sender's
// [whj | whi] row from the chunk's w-tile VMEM window with one-hot matmuls.

#include "fused_v2.cuh"

// whi / whj [N, H*F], ub [N, H], a [H, F], keepq [E_b, H] f32;
// band [n_chunks] int32, s_loc / local [E_b] int32, chunk_tile [n_chunks]
// int32 (the plan's band, s_loc, r_local and r_chunk); out
// [n_tiles * 128, H*F] and den [n_tiles * 128, H] f32. Zeroes out and den
// and launches on `stream`; returns the first CUDA error, or
// cudaGetLastError() after the launch (cudaErrorInvalidValue when F > 256).
extern "C" int pygat_fused_v2_banded(const float* whi, const float* whj,
                                     const float* ub, const float* a,
                                     const float* keepq, const int* band,
                                     const int* s_loc, const int* local,
                                     const int* chunk_tile, int n_chunks,
                                     int n_tiles, int w, int H, int F,
                                     float alpha, float* out, float* den,
                                     void* stream) {
  return launch_fused_v2(whi, whj, ub, a, keepq,
                         WindowRows{band, s_loc, w * TILE}, local, chunk_tile,
                         n_chunks, n_tiles, H, F, alpha, out, den, stream);
}
