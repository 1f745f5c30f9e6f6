// Fused GATv2 attention forward over the receiver stream with a pre-built
// sender window, for Hopper (sm_90a): the corner path's forward. Replaces
// the Pallas TPU kernel pygat_tpu/ops/fused_stream.py::_make_v2_kernel as
// pygat_tpu/ops/fused_corner.py launches it (through _grid_call) over the
// [gj | gi] windows that the CSC expand and the corner-turn passes built;
// the kernel and what bounds it are described in fused_v2.cuh. Slot k's
// sender-side rows are columns [0, HF) (whj) and [HF, 2HF) (whi) of row k
// of the window (slot_rows.cuh: SlotRows, row stride 2HF); the receiver
// side reads whi[r] and ub[r] from the node tables.

#include "fused_v2.cuh"

// whi [N, H*F], win [E_s, 2*H*F] (row k: [whj | whi] at slot k's sender),
// ub [N, H], a [H, F], keepq [E_s, H] f32; local [E_s] int32; chunk_tile
// [n_chunks] int32; out [n_tiles * 128, H*F] and den [n_tiles * 128, H]
// f32. Zeroes out and den and launches on `stream`; returns the first CUDA
// error, or cudaGetLastError() after the launch (cudaErrorInvalidValue when
// F > 256).
extern "C" int pygat_fused_v2_window(const float* whi, const float* win,
                                     const float* ub, const float* a,
                                     const float* keepq, const int* local,
                                     const int* chunk_tile, int n_chunks,
                                     int n_tiles, int H, int F, float alpha,
                                     float* out, float* den, void* stream) {
  const int hf = H * F;
  return launch_fused_v2(whi, win, win + hf, 2 * hf, ub, a, keepq,
                         SlotRows{}, local, chunk_tile, n_chunks, n_tiles, H,
                         F, alpha, out, den, stream);
}
