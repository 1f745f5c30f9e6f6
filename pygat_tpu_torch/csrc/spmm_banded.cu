// Fused banded SpMM for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pygat_tpu/ops/banded.py::
// _make_spmm_banded_kernel (launched by _spmm_banded_fused_impl, 'high'
// precision). Same function: out[i] = sum over the slots k with receiver i
// of vals[k] * x[band[c] * 128 + s_loc[k]] (c = k / 256), where the receiver
// of slot k is r_chunk[c] * 128 + r_local[k]; a slot with s_loc >= w * 128
// or r_local == 128 is dead and adds nothing. The plan names a dead slot's
// sender row -1 in its SpMM walk: formed, a dead slot of a chunk on the last
// band would name row N_pad, one past the table.
//
// The TPU kernel DMAs the chunk's w window tiles into VMEM, selects and
// scales rows with a vals-weighted one-hot matmul, scatters them with the
// receiver one-hot, and keeps the output tile resident across the
// consecutive chunks that write it. The first port ran one block per chunk
// and per 64 columns on stream_scatter.cuh's body (98 KB of shared memory,
// two blocks per SM, three phases between barriers) and took 4.4690 ms at
// 524k, L = 128, against 0.6052 ms for torch.sparse.mm. Its phases, by
// altered copies (pygat_tpu_torch/tools/spmm_ab.py --ablate; NVIDIA H100
// 80GB HBM3, 700.00 W): plain stores in place of the drain's global
// atomics saved 0.03 %, skipping the window loads 20.1 %, the memset of
// the output is 1.9 %; the rest, 78 %, was per-block latency (staging the
// chunk's indices, the walk's shared-memory atomics, which are
// compare-and-swap loops on sm_90, the barriers): 32-column slabs were
// 15.6 % faster and L = 64, one slab, took half the time.
//
// Here a block owns an output tile and walks its chunk range, as the TPU
// kernel does, with the tile's sum in shared memory, one barrier per chunk
// and none between loading and adding (tile_spmm.cuh). It walks each
// tile's slots with receivers ascending, so that a receiver's slots sum in
// registers: the plan's SpMM walk (BandPlan.spmm_walk, built on the card
// at the plan's first SpMM call): the slot at each position, and by
// position its sender band[k / 256] * 128 + s_loc[k] (-1 when dead, through
// slot_rows.cuh's ListedRows) and its local row, so that the walk reads its
// index words in order and only the values through the slot order; the
// values scale the rows as they are read, so the [E_b, L] message array
// never reaches memory. Walking the plan's own sender order was 1.05x
// slower, and taking the rows through WindowRows{band, s_loc, w*128} and
// the local rows through the slot order 1.08x. It takes 0.5781–0.5786 ms at
// 524k, L = 128, against 0.5971–0.6091 ms for torch.sparse.mm in the same
// runs (tools/spmm_ab.py).
//
// Bound on the H100: bytes of the function: x once, out once, per slot its
// value, s_loc and r_local, per chunk its band and tile (0.18289 ms at 524k,
// L = 128: chip_smoke.py phase 6 on an NVIDIA H100 80GB HBM3, 700.00 W);
// two FLOPs per live slot and column. The walk's slot order, a fourth word
// a slot, is this kernel's own layout and not counted.

#include "tile_spmm.cuh"

// vals [E_b] f32 in banded order; x [n_tiles * 128, L] f32; rows, local,
// order [E_b] int32: the walk of each tile's slots with
// receivers ascending, by position: the sender row (-1 when dead), the local
// row (128 when dead) and the banded slot, whose value is taken; tile_ptr
// [n_tiles + 1] int32 (tile t owns positions tile_ptr[t] * 256 ..
// tile_ptr[t + 1] * 256 - 1) and split_at [n_split] int32 (the chunks
// where a split tile's pieces start), from tile_ranges in ops/stream.py;
// part [n_split, 128, L] f32 scratch; out [n_tiles * 128, L] f32, every row
// written. Launches on `stream`; returns the first CUDA error, or
// cudaGetLastError() after the launches.
extern "C" int pygat_spmm_banded(const float* vals, const float* x,
                                 const int* rows, const int* local,
                                 const int* order, const int* tile_ptr,
                                 const int* split_at, int n_tiles,
                                 int n_split, int L, float* out, float* part,
                                 void* stream) {
  return launch_tile_spmm(x, ListedRows{rows},
                          SlotValues{vals, nullptr, order}, local,
                          tile_ptr, split_at, n_tiles, n_split, L, out, part,
                          stream);
}
