// Panel-gather SpMM of a bf16 table for Hopper (sm_90a): the one-limb
// instantiation of panel_spmm.cu.
//
// Replaces the Pallas TPU kernel pygat_tpu/ops/panel.py::_make_spmm_kernel
// at two_limb=False (launched by _panel_fwd_impl under
// precision="fastest"), which casts x to bf16, selects the panel rows with
// a one-hot matmul, scales them by the slot's f32 value (unrounded), and
// rounds each message to bf16 before the receiver one-hot sums them in
// f32. Here the wrapper (ops/panel.py panel_weighted_sum) makes that bf16
// copy of x, and the tile-owner body tile_spmm.cuh reads it, 2 bytes a
// value where panel_spmm.cu reads 4: each message w * x[s] formed in f32
// and rounded to bf16 before it is added (OneLimbMsg<false>), the sum f32
// in the receiver order. The overflow slots stay the caller's f32 pass over
// the f32 x, as the reference's. Same layout, split tiles and result
// layout as panel_spmm.cu.
//
// Bound on the H100: bytes of the function: the bf16 x once, out once (f32),
// per slot its value, mask byte and two index words, per chunk its tile,
// the panel table; two FLOPs per live slot and column (and a rounding).

#include "tile_spmm.cuh"

// vals [E_s] f32; mask [E_s] bool; x [n_tiles * 128, L] bf16; panel_tiles,
// g_idx, r_local, r_chunk, tile_ptr, split_at, n_tiles, n_split, p, L, out
// [n_tiles * 128, L] f32 and part [n_split, 128, L] f32 as in
// panel_spmm.cu. Launches on `stream`; returns the first CUDA error, or
// cudaGetLastError() after the launches.
extern "C" int pygat_panel_spmm_bf16(const float* vals,
                                     const unsigned char* mask,
                                     const __nv_bfloat16* x,
                                     const int* panel_tiles, const int* g_idx,
                                     const int* r_local, const int* r_chunk,
                                     const int* tile_ptr, const int* split_at,
                                     int n_tiles, int n_split, int p, int L,
                                     float* out, float* part, void* stream) {
  return launch_tile_spmm<OneLimbMsg<false>>(
      x, PanelRows{panel_tiles, r_chunk, g_idx, p},
      SlotValues{vals, mask, nullptr}, r_local, tile_ptr, split_at, n_tiles,
      n_split, L, out, part, stream);
}
