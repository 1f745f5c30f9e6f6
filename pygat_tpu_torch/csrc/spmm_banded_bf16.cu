// Fused banded SpMM of a bf16 table for Hopper (sm_90a): the one-limb
// instantiation of spmm_banded.cu.
//
// Replaces the Pallas TPU kernel pygat_tpu/ops/banded.py::
// _make_spmm_banded_kernel at exact=False (launched by
// _spmm_banded_fused_impl under precision="fastest"), which casts x to
// bf16, folds each slot's value into the select one-hot and rounds that to
// bf16 (_window_select(..., scale=vals)), so the select gives the product
// bf16(v) * bf16(x[s]) (exact in f32), rounds it to bf16 again and sums
// the rounded messages per receiver in f32. Here the wrapper
// (ops/banded.py banded_weighted_sum) makes that bf16 copy of x, and the
// tile-owner body tile_spmm.cuh reads it, 2 bytes a value where
// spmm_banded.cu reads 4: the value is rounded to bf16 when its slot is
// staged, each message formed in f32 and rounded to bf16 before it is
// added (OneLimbMsg<true>), the sum f32 in the walk's order. Same walk,
// split tiles and result layout as spmm_banded.cu.
//
// Bound on the H100: bytes of the function: the bf16 x once, out once (f32),
// per slot its value, s_loc and r_local, per chunk its band and tile; two
// FLOPs per live slot and column (and two roundings).

#include "tile_spmm.cuh"

// vals [E_b] f32 in banded order; x [n_tiles * 128, L] bf16; rows, local,
// order, tile_ptr, split_at, n_tiles, n_split, L, out [n_tiles * 128, L]
// f32 and part [n_split, 128, L] f32 as in spmm_banded.cu. Launches on
// `stream`; returns the first CUDA error, or cudaGetLastError() after the
// launches.
extern "C" int pygat_spmm_banded_bf16(const float* vals,
                                      const __nv_bfloat16* x, const int* rows,
                                      const int* local, const int* order,
                                      const int* tile_ptr, const int* split_at,
                                      int n_tiles, int n_split, int L,
                                      float* out, float* part, void* stream) {
  return launch_tile_spmm<OneLimbMsg<true>>(
      x, ListedRows{rows}, SlotValues{vals, nullptr, order}, local, tile_ptr,
      split_at, n_tiles, n_split, L, out, part, stream);
}
