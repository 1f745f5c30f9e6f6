// Panel-gather SpMM for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pygat_tpu/ops/panel.py::_make_spmm_kernel
// (launched by _panel_fwd_impl, 'high' precision). Same function: over the
// receiver stream, out[i] = sum over the slots k with receiver i (r_chunk[c]
// * 128 + r_local[k], c = k / 256) whose panel index g = g_idx[k] is below
// p * 128 of w[k] * x[panel_tiles[r_chunk[c], g / 128] * 128 + g % 128],
// where w[k] = vals[k] if edge_mask[k], else 0. A slot with g == p * 128 is
// dead or overflows its tile's panels and adds nothing here: the caller
// adds the overflow slots in a second pass (the TPU version does that pass
// in XLA, outside its kernel). g is tested before a row is formed: the
// padded columns of panel_tiles hold tile 0. A slot whose mask is false
// reads nothing of x.
//
// The TPU kernel DMAs the output tile's p panel tiles into VMEM once per
// tile, selects rows from them with a one-hot matmul, and keeps the output
// tile resident across the consecutive chunks that write it. The first
// port ran one block per chunk and per 64 columns on stream_scatter.cuh's
// body and took 3.2946 ms at 524k, L = 128, P = 17, against 0.5963 ms for
// torch.sparse.mm. Its phases, by altered copies (pygat_tpu_torch/tools/
// spmm_ab.py --ablate; NVIDIA H100 80GB HBM3, 700.00 W): plain stores in
// place of the drain's global atomics saved 0.2 %, skipping the window
// loads 28.6 %, the memset of the output is 2.5 %; the rest, 69 %, was
// per-block latency (staging the chunk's indices through the two-load
// g_idx -> panel_tiles chain, the walk's shared-memory atomics, which are
// compare-and-swap loops on sm_90, the barriers): 32-column slabs were
// 17.9 % faster and L = 64, one slab, took half the time.
//
// Here a block owns an output tile and walks its chunk range, as the TPU
// kernel does, with the tile's sum in shared memory, one barrier per chunk
// and none between loading and adding (tile_spmm.cuh): slot k's row comes
// through slot_rows.cuh's PanelRows, scaled by w[k], and the receiver
// order's runs of equal rows sum in registers, so the [E_s, L] message
// array never reaches memory. A tile's rows lie in its panels, so on a
// local graph they come from L2 after the first touch. It takes
// 0.5793–0.5805 ms at 524k, L = 128, P = 17 (0.4317–0.4352 ms at p_max 8;
// 0.0298–0.0301 ms on the Pubmed stand-in, P = 155, two blocks a tile),
// against 0.5957–0.6002 ms for torch.sparse.mm in the same runs
// (0.5956–0.6001; 0.0310) (tools/spmm_ab.py).
//
// Bound on the H100: bytes of the function: x once, out once, per slot its
// value, mask byte and two index words, per chunk its tile, the panel table
// (0.18076 ms at 524k, L = 128, P = 17: chip_smoke.py phase 6 on an NVIDIA
// H100 80GB HBM3, 700.00 W); two FLOPs per live slot and column. The tile
// ranges, this kernel's own layout, are not counted.

#include "tile_spmm.cuh"

// vals [E_s] f32; mask [E_s] bool; x [n_tiles * 128, L] f32; panel_tiles
// [n_tiles, p] int32; g_idx, r_local [E_s] int32; r_chunk [C] int32;
// tile_ptr [n_tiles + 1] int32 (tile t owns chunks tile_ptr[t] ..
// tile_ptr[t + 1] - 1) and split_at [n_split] int32 (the chunks where a
// split tile's pieces start), both from tile_ranges in ops/stream.py; part
// [n_split, 128, L] f32 scratch; out [n_tiles * 128, L] f32, every row
// written. Launches on `stream`; returns the first CUDA error, or
// cudaGetLastError() after the launches.
extern "C" int pygat_panel_spmm(const float* vals, const unsigned char* mask,
                                const float* x, const int* panel_tiles,
                                const int* g_idx, const int* r_local,
                                const int* r_chunk, const int* tile_ptr,
                                const int* split_at, int n_tiles, int n_split,
                                int p, int L, float* out, float* part,
                                void* stream) {
  return launch_tile_spmm(x, PanelRows{panel_tiles, r_chunk, g_idx, p},
                          SlotValues{vals, mask, nullptr}, r_local, tile_ptr,
                          split_at, n_tiles, n_split, L, out, part, stream);
}
