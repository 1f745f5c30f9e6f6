// Fused GATv2 attention forward over the receiver stream, for Hopper
// (sm_90a). Replaces the Pallas TPU kernel pygat_tpu/ops/fused_stream.py::
// _make_v2_kernel (launched through _grid_call by _v2_fwd_impl); the kernel
// and what bounds it are described in fused_v2.cuh. Slot k's sender is
// senders[k].

#include "fused_v2.cuh"

// whi / whj [N, H*F], ub [N, H], a [H, F], keepq [E_s, H] f32;
// senders / local [E_s] int32; chunk_tile [n_chunks] int32;
// out [n_tiles * 128, H*F] and den [n_tiles * 128, H] f32. Zeroes out and
// den and launches on `stream`; returns the first CUDA error, or
// cudaGetLastError() after the launch (cudaErrorInvalidValue when F > 256).
extern "C" int pygat_fused_v2(const float* whi, const float* whj,
                              const float* ub, const float* a,
                              const float* keepq, const int* senders,
                              const int* local, const int* chunk_tile,
                              int n_chunks, int n_tiles, int H, int F,
                              float alpha, float* out, float* den,
                              void* stream) {
  return launch_fused_v2(whi, whj, whi, H * F, ub, a, keepq,
                         ListedRows{senders}, local, chunk_tile, n_chunks,
                         n_tiles, H, F, alpha, out, den, stream);
}
