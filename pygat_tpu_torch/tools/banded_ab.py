"""Time the fused attention forwards (kernel rows 2, 3 and 8) of one
checkout of this repository on the card, for an A/B of two commits in one
call (parent, change, change, parent):

    python pygat_tpu_torch/tools/banded_ab.py ROOT --tag NAME [--out DIR] [--ablate] [--epochs]
    python pygat_tpu_torch/tools/banded_ab.py ROOT --tag NAME --bcsr [--out DIR] [--ablate]
    python pygat_tpu_torch/tools/banded_ab.py ROOT --tag NAME --gathers [--out DIR] [--ablate] [--epochs] [--f2 F]

``ROOT`` is a checkout of the repository (for the parent, a ``git archive``
unpacked into a directory that ``.gitignore`` lists). The script imports
``ROOT``'s ``pygat_tpu_torch`` and ``chip_smoke.py``, builds ``ROOT``'s
kernels into ``ROOT``'s own build directory, and times each forward
through its wrapper, each call first held against its plain version
(``chip_smoke.KERNEL_RTOL`` of the largest output; the plain version in
f64 where the checkout has ``f64=``, beside which the kernel's and the
f32 plain version's relative errors are recorded; a disagreement is
printed and makes the exit code 1 once the results are written) and
called twice (is the second result equal bit for bit?), at:

* the band plans (row 8, ``fused_v1_banded``, ``fused_v2_banded``): the
  524k clustered graph's (``maybe_plan_large``) at both layers' shapes of
  both models (H 8 F 8, H 1 F 4), whose sum is one forward, and H 1 F 64
  and H 1 F 256; Cora's (``set_band("on")``, w = 4) at H 8 F 8 and H 1
  F 7; the hub graph's (``chip_smoke._hub_graph``, w = 4, its hub tile cut
  into pieces) at H 8 F 8;
* the receiver stream (rows 2 and 3, ``fused_v1``, ``fused_v2``): the 524k
  graph's (the order ``set_band("off")`` trains over) at the same four
  shapes; Cora's at H 8 F 8 and H 1 F 7; Pubmed's, ``fused_v2`` only, at
  H 8 F 8 and H 8 F 3; the hub graph's at H 8 F 8;
* the corner windows (rows 2 and 3 over a pre-built window,
  ``fused_v1_window``, ``fused_v2_window``): the 524k graph's corner plans
  at H 8 F 8 and H 1 F 4;

each beside its bound (``chip_smoke``'s: bytes of the function over the
memory rate). At F 256 the plain version is not run (some 30 GB of
gathers); the GPU tests hold that width. The stream and window forwards of
a checkout whose wrappers take the graph's walk (``walk=``,
``Graph.stream_walk``) get it; those of an older checkout run without.

``--bcsr`` times kernel row 11 (``bcsr_attention``, the BCSR fused
attention) instead, through ``ROOT``'s wrapper, at ``chip_smoke.py``'s
phase-7 shapes (Cora H 8 F 8 and H 1 F 7, Pubmed H 8 F 8 and H 8 F 3, 524k
H 8 F 8) and on the hub graph at H 8 F 8, without a dropout mask, each
tiled by ``ROOT``'s ``tile_graph``: ``ROOT``'s ``chip_smoke._time_bcsr``
times the kernel, its plain version and, at 524k, rows 2 and 8 over the
same attention (``fused_v1``, ``fused_v1_banded``), beside the bound;
then each call is held against the plain version (in f64 where ``ROOT``
has ``f64=``) and called twice (is the second result equal bit for bit?).
With ``--ablate`` it also builds altered copies of ``ROOT``'s
``csrc/bcsr_attention.cu`` and times each through the wrapper at every
shape (device time only; most alter the result). Of the earlier
block-per-(tile, head, slab) body: ``pass1`` (the max pass alone), ``pass2`` (the exp and sum
pass alone) and ``nopasses`` (neither: the shared-memory set-up and the
row stores). Of the walk body: ``nofsrc`` (no f_src gather: logits from
f_dst alone), ``fsrc_heads`` (f_src gathered head-major in place, H
sectors a position, not from its node-major copy), ``nocopy`` (the
node-major copy of f_src not made), ``cols4`` (lanes of up to 4
columns: two lanes a head at F 8), ``occ3`` and ``occ4`` (at most 85 or
64 registers a thread: three or four blocks of 256 threads an SM),
``l2only`` and ``evictfirst`` (every load of the kernel's file cached in L2
only, or marked evict-first, in place of the read-only path), ``nowh`` (no wh row gather),
``norescale`` (the max of a run's first
batch kept: no online rescale), ``nomerge`` (the segments of a cut run
added, not merged into the larger max), ``nocombine`` (no combine of a
cut tile's pieces), ``nosplit`` (no cut of long runs), ``batch2`` and
``batch8`` (2 or 8 positions in flight instead of 4) and ``threads128``
(blocks of at most 128 threads); ``fsrc_heads``, ``cols4``, ``occ3``,
``occ4``, ``l2only`` and ``evictfirst`` give the same result too. The results go to
``OUT/banded_ab_NAME.json`` under ``"bcsr"`` and ``"bcsr_ablate"``.

``--gathers`` times the row gathers instead: kernel row 5 (``banded_take``)
in both precisions and, as controls, rows 4 (``expand``) and 10
(``permute_pass``), at the widths one train step of each model gives them
(row 5: GATv1 L = HF, GATv2 2HF; row 4: GATv1 3H + HF, GATv2 2HF + 2H;
row 10: the corner turns' HF and 2HF, every pass of both plans; H F 8 x 8,
then 1 x the dataset's classes: 4 at 524k, or ``--f2``, 7 at Cora): on the
524k graph's band plan and corner plans, and row 5 also on Cora's band plan
(w = 4). Each kernel is launched through ``ROOT``'s entry point on a
preallocated output (GATHER_CALLS calls a captured graph), row 5 also
through its wrapper (the one-limb wrapper with its bf16 cast in a checkout
whose kernel reads a bf16 table; then the cast and the kernel alone on a
bf16 copy are timed too); each output is held against its plain version bit
for bit, a second call against the first, and its bits are summed into a
checksum (``bits``) that compares checkouts; beside each, the bound (the
f32 table once, the output in its type, the index words, over the memory
rate). With ``--epochs`` it also times the 524k fast-loop epoch of both
models over the band plan in both precisions, in turns. With ``--ablate``
it builds altered copies of ``ROOT``'s row gather (``csrc/take_rows.cuh``)
and times each at the 524k shapes through the entry point: ``bulk`` (the
f32 copy by ``cp.async.bulk`` rows and one bulk store a chunk),
``staged`` (narrow rows of more than 4 vectors under 16 bytes staged in
shared memory and written as the chunk's block by 16-byte stores),
``wide8`` (at most 8 rows in flight for wide rows, not 16),
``nostcs`` (plain
stores in place of streaming ones) and ``bf16table`` (the one-limb entry
point on a bf16 table: the cast path, timed with and without its cast);
all give the same result. The results go to ``OUT/banded_ab_NAME.json``
under ``"gathers"``, ``"gathers_ablate"`` and ``"epoch_ms"``.

``--epochs`` also times, with ``ROOT``'s ``chip_smoke`` helpers, the Cora
fast-loop epoch of both models and the 524k fast-loop epoch of both models
over the band plan, the corner plans and the receiver stream in turns.

``--ablate`` also builds altered copies of the tile-owner body
(``csrc/tile_fused.cuh``) and times each at the 524k H 8 F 8 shape (device
time only: most alter the result), for the banded kernels and, in a
checkout whose stream kernels run on that body, the stream kernels:
``nokeep`` (no keep factor loads: every factor 1), ``batch2`` and
``batch8`` (2 or 8 slots in flight per unit instead of 4; the same result)
and ``threads128`` (blocks of at most 128 threads instead of 256; the same
result). Device times come from ``chip_smoke._time_ms`` (calls captured in
a CUDA graph and replayed between CUDA events). The results go to
``OUT/banded_ab_NAME.json`` (``--out``, by default the current directory)
and, one line per number, to standard output.
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import os
import re
import shutil
import subprocess
import sys
import time

BANDED = ("fused_v1_banded", "fused_v2_banded")
STREAM = ("fused_v1", "fused_v2")
# text of tile_fused.cuh -> its ablated form, each found the stated number
# of times
_ABLATIONS = {
    "nokeep": [(r"\? __ldg\(p\.keepq \+ static_cast<long long>\(o\[u\]\) "
                r"\* H \+ ln\.h\)", "? 1.f", 1)],
    "batch2": [(r"constexpr int TF_BATCH = 4;", "constexpr int TF_BATCH = 2;",
                1)],
    "batch8": [(r"constexpr int TF_BATCH = 4;", "constexpr int TF_BATCH = 8;",
                1)],
    "threads128": [(r"constexpr int TF_THREADS = 256;",
                    "constexpr int TF_THREADS = 128;", 1)],
}


def _stream_on_body(root):
    """Whether ``root``'s stream and window kernels run on the tile-owner
    body (its walk policies are there)."""
    path = os.path.join(root, "pygat_tpu_torch", "csrc", "tile_fused.cuh")
    with open(path) as f:
        return "ListWalk" in f.read()


def _ablated_libs(root, build, kernels):
    """Build ``kernels`` of ``root`` against each ablated copy of
    tile_fused.cuh, all nvcc processes at once; returns {variant: {kernel:
    ctypes function}}."""
    csrc = os.path.join(root, "pygat_tpu_torch", "csrc")
    out_dir = os.path.join(root, "pygat_tpu_torch", "_build", "ablate_fused")
    with open(os.path.join(csrc, "tile_fused.cuh")) as f:
        body = f.read()
    procs = []
    for variant, subs in _ABLATIONS.items():
        vdir = os.path.join(out_dir, variant)
        shutil.rmtree(vdir, ignore_errors=True)
        shutil.copytree(csrc, vdir)
        text = body
        for pattern, repl, want in subs:
            text, hits = re.subn(pattern, repl, text)
            if hits != want:
                raise RuntimeError(f"{variant}: {pattern!r} matched {hits} "
                                   f"times, not {want}")
        with open(os.path.join(vdir, "tile_fused.cuh"), "w") as f:
            f.write(text)
        for kernel in kernels:
            lib = os.path.join(vdir, f"{kernel}.so")
            cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib,
                   os.path.join(vdir, f"{kernel}.cu")]
            procs.append((variant, kernel, lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    libs = {}
    for variant, kernel, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {variant} {kernel}:\n{log.decode()}")
        symbol, argtypes = build.ENTRY_POINTS[kernel]
        fn = getattr(ctypes.CDLL(lib), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        libs.setdefault(variant, {})[kernel] = fn
    return libs


def _c_args(kernel, args, graph, torch):
    """(C arguments up to the stream, outputs) of a wrapper call's arguments
    for the tile-owner entry points: a banded one (``args`` end in the plan)
    or a stream one (the graph's walk)."""
    a = args[3]
    h, f = a.shape
    if kernel in BANDED:
        plan = args[5]
        walk = plan.spmm_walk
        words = (walk.rows, walk.order)
        ptrs = (walk.row_ptr, plan.tile_ptr, plan.split_at, plan.max_run)
    else:
        words = (args[5],)  # the senders
        ptrs = tuple(graph.stream_walk)
    n_pad, n_split = args[0].shape[0], ptrs[2].numel()
    out = torch.empty(n_pad, h * f, device="cuda")
    den = torch.empty(n_pad, h, device="cuda")
    part_out = torch.empty(max(n_split, 1), 128, h * f, device="cuda")
    part_den = torch.empty(max(n_split, 1), 128, h, device="cuda")
    tables = args[:5]
    if kernel == "fused_v2":  # whi at the receivers, then at the senders
        tables = (args[0], *tables)
    c = (*tables, *words, *ptrs[:3], n_pad // 128, n_split, ptrs[3], h, f,
         args[-1], out, den, part_out, part_den)
    c = [x.data_ptr() if isinstance(x, torch.Tensor) else x for x in c]
    return c, (out, den)


def _call(fn, c_args, kernel):
    """Launch a kernel library's entry point on the current stream (inside a
    CUDA-graph capture, the capturing one)."""
    import torch

    rc = fn(*c_args, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"{kernel}: CUDA error {rc} at launch")


def _bound_ms(cs, kernel, n, h, f, n_live, index_words):
    """chip_smoke's bound of a fused forward: each node table once (over a
    window: the live slots' rows), the per-node head terms, a, a live slot's
    keep factors, the edge order's index words, out and den once."""
    v1 = kernel.startswith("fused_v1")
    hf = h * f
    if kernel == "fused_v1_window":
        tables = n_live * hf
    elif kernel == "fused_v2_window":
        tables = n * hf + n_live * 2 * hf
    else:
        tables = (1 if v1 else 2) * n * hf
    n_bytes = 4 * (tables + (2 if v1 else 1) * n * h + hf + n_live * h
                   + index_words + n * (hf + h))
    return cs._bound(n_bytes, n_live * ((4 if v1 else 6) * hf + 6 * h))[0]


def _walk_kw(graph):
    """The walk keyword of the stream and window wrappers of a checkout
    that has one (``Graph.stream_walk``), else none."""
    return ({"walk": graph.stream_walk}
            if hasattr(type(graph), "stream_walk") else {})


# the row-11 shapes (chip_smoke.py phase 7's, and the hub graph)
BCSR_SHAPES = (("cora", ((8, 8), (1, 7))), ("pubmed", ((8, 8), (8, 3))),
               ("large", ((8, 8),)), ("hub", ((8, 8),)))
# text of csrc/bcsr_attention.cu -> its ablated form: of the earlier
# block-per-(tile, head, slab) body (found by its "pass 1" comment), then
# of the walk body
_BCSR_OLD = {
    "pass1": [(r"for \(long long base = k0; base < k1; base \+= THREADS\)",
               "for (long long base = k0; base < k0; base += THREADS)", 1)],
    "pass2": [(r"for \(long long k = k0 \+ threadIdx\.x; k < k1; "
               r"k \+= THREADS\)",
               "for (long long k = k0 + threadIdx.x; k < k0; k += THREADS)",
               1)],
    "nopasses": [(r"base < k1; base \+= THREADS\)",
                  "base < k0; base += THREADS)", 1),
                 (r"k < k1; k \+= THREADS\)", "k < k0; k += THREADS)", 1)],
}
_BCSR_WALK = {
    "nofsrc": [(r"lg\[u\] = u < n && ln\.on \? __ldg\(fs \+ static_cast<long "
                r"long>\(s\[u\]\) \* p\.H\)\s*: 0\.f;", "lg[u] = 0.f;", 1)],
    "fsrc_heads": [(r"const float\* fs = p\.f_src_t \+ ln\.h;",
                    "const float* fs = p.f_src + hrow;", 1),
                   (r"__ldg\(fs \+ static_cast<long long>\(s\[u\]\) \* p\.H\)",
                    "__ldg(fs + s[u])", 1)],
    "nocopy": [(r"  transpose_kernel<<<", "  if (false) transpose_kernel<<<",
                1)],
    "cols4": [(r"while \(p\.Q \* BA_MAX_C < fg\) p\.Q <<= 1;",
               "while (p.Q < BA_MAX_P && p.Q * 4 < fg) p.Q <<= 1;", 1)],
    "occ3": [(r"__launch_bounds__\(kSplit \? BA_SPLIT_THREADS : BA_THREADS\)",
              "__launch_bounds__(kSplit ? BA_SPLIT_THREADS : BA_THREADS, "
              "kSplit ? 6 : 3)", 1)],
    "occ4": [(r"__launch_bounds__\(kSplit \? BA_SPLIT_THREADS : BA_THREADS\)",
              "__launch_bounds__(kSplit ? BA_SPLIT_THREADS : BA_THREADS, "
              "kSplit ? 8 : 4)", 1)],
    "l2only": [(r'#include "tile_pieces\.cuh"',
                '#define __ldg __ldcg\n#include "tile_pieces.cuh"', 1)],
    "evictfirst": [(r'#include "tile_pieces\.cuh"',
                    '#define __ldg __ldcs\n#include "tile_pieces.cuh"', 1)],
    "nowh": [(r"load_cols<C, kVec>\(wh \+ static_cast<long long>\(s\[u\]\) "
              r"\* p\.F,\s*u < n \? ln\.nf : 0, v\[u\]\);",
              "for (int i = 0; i < C; ++i) v[u][i] = lg[u];", 1)],
    "norescale": [(r"if \(bm > st\.mx\) \{", "if (st.mx == neg_inf()) {",
                   1)],
    "nomerge": [(r"merge\(st, src\[0\], src\[1\], src \+ 2\);",
                 "st.mx = fmaxf(st.mx, src[0]); st.d += src[1]; "
                 "for (int i = 0; i < C; ++i) st.acc[i] += src[2 + i];", 1)],
    "nocombine": [(r"if \(rc != 0 \|\| n_split <= 0\) return rc;",
                   "return rc;", 1)],
    "nosplit": [(r"const bool split = max_run > BA_SPLIT;",
                 "const bool split = false;", 1)],
    "batch2": [(r"constexpr int BA_BATCH = 4;", "constexpr int BA_BATCH = 2;",
                1)],
    "batch8": [(r"constexpr int BA_BATCH = 4;", "constexpr int BA_BATCH = 8;",
                1)],
    "threads128": [(r"constexpr int BA_THREADS = 256;",
                    "constexpr int BA_THREADS = 128;", 1)],
}


def _bcsr_ablated(root, build):
    """Build altered copies of ``root``'s bcsr_attention.cu (the earlier
    body's variants or the walk body's), all nvcc processes at once;
    returns {variant: ctypes function}."""
    csrc = os.path.join(root, "pygat_tpu_torch", "csrc")
    out_dir = os.path.join(root, "pygat_tpu_torch", "_build", "ablate_bcsr")
    with open(os.path.join(csrc, "bcsr_attention.cu")) as f:
        body = f.read()
    table = _BCSR_OLD if "// pass 1:" in body else _BCSR_WALK
    procs = []
    for variant, subs in table.items():
        vdir = os.path.join(out_dir, variant)
        shutil.rmtree(vdir, ignore_errors=True)
        shutil.copytree(csrc, vdir)
        text = body
        for pattern, repl, want in subs:
            text, hits = re.subn(pattern, repl, text)
            if hits != want:
                raise RuntimeError(f"{variant}: {pattern!r} matched {hits} "
                                   f"times, not {want}")
        with open(os.path.join(vdir, "bcsr_attention.cu"), "w") as f:
            f.write(text)
        lib = os.path.join(vdir, "bcsr_attention.so")
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib,
               os.path.join(vdir, "bcsr_attention.cu")]
        procs.append((variant, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    fns = {}
    for variant, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc bcsr {variant}:\n{log.decode()}")
        symbol, argtypes = build.ENTRY_POINTS["bcsr_attention"]
        fn = getattr(ctypes.CDLL(lib), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[variant] = fn
    return fns


def _bcsr_section(cs, root, graphs, large, plan, build, ablate, torch):
    """Kernel row 11 of the checkout on the card (``--bcsr``): returns
    (cases, ablation rows)."""
    from pygat_tpu_torch.legacy_bcsr import fused_attention as bfa
    from pygat_tpu_torch.legacy_bcsr.tiles import tile_graph

    variants = _bcsr_ablated(root, build) if ablate else {}
    exact = ({"f64": True} if "f64" in inspect.signature(
        bfa.bcsr_attention_plain).parameters else {})
    cases, ablated = [], []
    for label, shapes in BCSR_SHAPES:
        g = graphs[label]
        t0 = time.perf_counter()
        tiles = tile_graph(g)
        torch.cuda.synchronize()
        tiling_s = time.perf_counter() - t0
        n_valid = int(tiles.valid.sum())
        for i, (h, f) in enumerate(shapes):
            fd, fs, wh, _ = cs._bcsr_inputs(g, h, f, 60 + i)
            args = (fd, fs, wh, tiles, 0.2, None)
            case = dict(kernel="bcsr_attention", dataset=label, H=h, F=f,
                        dropout=0.0, args=args, n_valid=n_valid,
                        tiling_s=tiling_s)
            # times the kernel, its plain version and, at 524k, rows 2 and 8
            cs._time_bcsr(case, large if label == "large" else None, plan)
            got = bfa.bcsr_attention(*args)
            again = bfa.bcsr_attention(*args)
            want = bfa.bcsr_attention_plain(*args, **exact)
            torch.cuda.synchronize()
            errs = [cs._max_err(a, b) for a, b in zip(got, want)]
            case["max_abs_err"] = max(e for e, _ in errs)
            case["within_tolerance"] = all(e <= a for e, a in errs)
            case["bitwise_repeat"] = all(
                torch.equal(a, b) for a, b in zip(got, again))
            case["oracle"] = "f64" if exact else "f32"
            print(f"  bcsr_attention {label} H {h} F {f}: error "
                  f"{case['max_abs_err']:.3e} against the {case['oracle']} "
                  f"plain version (within tolerance: "
                  f"{case['within_tolerance']}), bitwise repeat "
                  f"{case['bitwise_repeat']}", flush=True)
            cases.append(case)
            del got, again, want
            if variants:
                row = dict(dataset=label, H=h, F=f,
                           base_ms=cs._time_ms(lambda: bfa.bcsr_attention(
                               *args)))
                base = build.kernel("bcsr_attention")
                try:
                    for v, fn in variants.items():
                        build._KERNELS["bcsr_attention"] = fn
                        row[f"{v}_ms"] = cs._time_ms(
                            lambda: bfa.bcsr_attention(*args))
                finally:
                    build._KERNELS["bcsr_attention"] = base
                print(f"  bcsr_attention.cu {label} H {h} F {f}: " + ", ".join(
                    f"{k} {v:.4f}" for k, v in row.items()
                    if k.endswith("_ms")), flush=True)
                ablated.append(row)
            del args, fd, fs, wh
            torch.cuda.empty_cache()
        del tiles
        torch.cuda.empty_cache()
    return cases, ablated


# the bulk-copy form of row 5's f32 copy (the "bulk" ablation), inserted
# into a copy of csrc/take_rows.cuh: a kernel, and its launch where rows are
# a multiple of 16 bytes and both pointers 16-byte aligned
_TAKE_BULK_KERNEL = """// The bulk-copy form of a copy: one cp.async.bulk per live row
// into shared memory, completing on one mbarrier, dead rows zeroed by the
// threads, then one bulk store of the chunk's [256, L] output block. Rows
// of a multiple of 16 bytes, 16-byte aligned pointers, EC * row bytes of
// dynamic shared memory (opted in past 48 KB).
template <class T>
__global__ void __launch_bounds__(TK_THREADS)
take_rows_bulk_kernel(const T* __restrict__ table, WindowRows rows, int L,
                      T* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char s_rows[];
  __shared__ __align__(8) unsigned long long bar;
  const unsigned rb = static_cast<unsigned>(L * sizeof(T));
  const long long k0 = static_cast<long long>(blockIdx.x) * EC;
  const int r = rows(k0 + threadIdx.x, blockIdx.x);
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(&bar));
  const unsigned mine =
      static_cast<unsigned>(__cvta_generic_to_shared(s_rows)) +
      threadIdx.x * rb;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  const int n_live = __syncthreads_count(r >= 0);
  if (threadIdx.x == 0)
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b),
        "r"(static_cast<unsigned>(n_live) * rb)
        : "memory");
  if (r >= 0) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];" ::"r"(mine),
        "l"(reinterpret_cast<unsigned long long>(
            table + static_cast<long long>(r) * L)),
        "r"(rb), "r"(b)
        : "memory");
  } else {
    uint4* z = reinterpret_cast<uint4*>(s_rows + threadIdx.x * rb);
    for (unsigned i = 0; i < rb / 16; ++i) z[i] = uint4{};
  }
  // phase 0 of the barrier; a wait that never ends traps, not hangs
  unsigned done = 0;
  for (long long spins = 0; !done; ++spins) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "0; selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(b)
        : "memory");
    if (spins > (1LL << 26)) __trap();
  }
  // the zeros of dead rows (generic proxy) before the bulk store reads them
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
            reinterpret_cast<unsigned long long>(out + k0 * L)),
        "r"(static_cast<unsigned>(__cvta_generic_to_shared(s_rows))),
        "r"(EC * rb)
        : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

"""
_TAKE_BULK_LAUNCH = """  if constexpr (sizeof(Tin) == sizeof(Tout)) {
    const size_t row_bytes = static_cast<size_t>(L) * sizeof(Tout);
    const size_t smem = EC * row_bytes;
    constexpr int kMax = 227 * 1024 - 1024;  // the bulk kernel's opt-in
    static const cudaError_t opted = cudaFuncSetAttribute(
        take_rows_bulk_kernel<Tin>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMax);
    if (opted != cudaSuccess) return static_cast<int>(opted);
    if (row_bytes % 16 == 0 && t % 16 == 0 && o % 16 == 0 &&
        smem <= static_cast<size_t>(kMax)) {
      take_rows_bulk_kernel<Tin><<<n_chunks, TK_THREADS, smem, st>>>(
          table, rows, L, reinterpret_cast<Tin*>(out));
      return static_cast<int>(cudaGetLastError());
    }
  }
"""
# the staged form of narrow rows (the "staged" ablation), inserted into a
# copy of csrc/take_rows.cuh: the chunk's [256, L] output block gathered in
# shared memory, 4 rows in flight a lane, then written with 16-byte stores;
# for rows of more than 4 vectors under 16 bytes
_TAKE_STAGED_KERNEL = """template <class Tin, class Tout, int N>
__global__ void __launch_bounds__(TK_THREADS)
take_rows_staged_kernel(const Tin* __restrict__ table, WindowRows rows,
                        int L, int lg, Tout* __restrict__ out) {
  using M = Move<Tin, Tout, N>;
  using Out = typename M::Out;
  constexpr int B = TK_BATCH_NARROW;
  extern __shared__ uint4 s_stage[];
  __shared__ int s_row[EC];
  const long long k0 = static_cast<long long>(blockIdx.x) * EC;
  s_row[threadIdx.x] = rows(k0 + threadIdx.x, blockIdx.x);
  __syncthreads();
  const int G = 1 << lg;
  const int g = threadIdx.x >> lg, lane = threadIdx.x & (G - 1);
  const int rs = TK_THREADS >> lg;
  Tout* o = reinterpret_cast<Tout*>(s_stage);
  for (int col = lane * N; col < L; col += G * N) {
    for (int s0 = 0; s0 < G; s0 += B) {
      typename M::Raw v[B];
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const int r = s0 + b < G ? s_row[(s0 + b) * rs + g] : -1;
        v[b] = typename M::Raw{};
        if (r >= 0) v[b] = M::load(table + static_cast<long long>(r) * L + col);
      }
#pragma unroll
      for (int b = 0; b < B; ++b) {
        if (s0 + b >= G) break;
        *reinterpret_cast<Out*>(
            o + static_cast<long long>((s0 + b) * rs + g) * L + col) =
            M::put(v[b]);
      }
    }
  }
  __syncthreads();
  const int n16 = EC * L * static_cast<int>(sizeof(Tout)) / 16;
  uint4* dst = reinterpret_cast<uint4*>(out + k0 * L);
  for (int i = threadIdx.x; i < n16; i += TK_THREADS) dst[i] = s_stage[i];
}

"""
_TAKE_STAGED_LAUNCH = """  const size_t stage = static_cast<size_t>(EC) * L * sizeof(Tout);
  if (N * sizeof(Tout) < 16 && (1 << lg) > TK_BATCH_NARROW &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
      stage + EC * sizeof(int) <= 48 * 1024) {
    take_rows_staged_kernel<Tin, Tout, N>
        <<<n_chunks, TK_THREADS, stage, st>>>(table, rows, L, lg, out);
    return static_cast<int>(cudaGetLastError());
  }
"""
# row 5's row gather (csrc/take_rows.cuh) -> its altered copies: (file,
# pattern, replacement, matches)
_TAKE_ABLATIONS = {
    "bulk": [("take_rows.cuh", r"(?=template <class Tin, class Tout, int N, "
              r"int B>\nint launch_take\()", _TAKE_BULK_KERNEL, 1),
             ("take_rows.cuh", r"(?=  // the widest step whose vectors)",
              _TAKE_BULK_LAUNCH, 1)],
    "staged": [("take_rows.cuh", r"(?=// The instantiation of b rows a lane)",
                _TAKE_STAGED_KERNEL, 1),
               ("take_rows.cuh", r"(?=  constexpr int kWide = WideBatch<)",
                _TAKE_STAGED_LAUNCH, 1)],
    "wide8": [("take_rows.cuh", r"constexpr int TK_BATCH_MAX = 16;",
               "constexpr int TK_BATCH_MAX = 8;", 1)],
    "nostcs": [("take_rows.cuh", r"  __stcs\(p, v\);", "  *p = v;", 1)],
    "bf16table": [("banded_take_bf16.cu", r"const float\* table",
                   "const __nv_bfloat16* table", 1)],
}
TAKES = ("banded_take", "banded_take_bf16")
GATHER_CALLS, GATHER_REPLAYS = 20, 5


def _take_ablated(root, build):
    """Build the row-5 kernels of ``root`` against each altered copy, all
    nvcc processes at once; returns {variant: {kernel: ctypes function}}
    (``bf16table`` only the one-limb kernel, ``bulk`` only the f32 one)."""
    csrc = os.path.join(root, "pygat_tpu_torch", "csrc")
    out_dir = os.path.join(root, "pygat_tpu_torch", "_build", "ablate_take")
    procs = []
    for variant, subs in _TAKE_ABLATIONS.items():
        vdir = os.path.join(out_dir, variant)
        shutil.rmtree(vdir, ignore_errors=True)
        shutil.copytree(csrc, vdir)
        for name, pattern, repl, want in subs:
            with open(os.path.join(vdir, name)) as f:
                text, hits = re.subn(pattern, lambda m, r=repl: r, f.read())
            if hits != want:
                raise RuntimeError(f"{variant}: {pattern!r} matched {hits} "
                                   f"times in {name}, not {want}")
            with open(os.path.join(vdir, name), "w") as f:
                f.write(text)
        kernels = {"bf16table": ("banded_take_bf16",),
                   "bulk": ("banded_take",)}.get(variant, TAKES)
        for kernel in kernels:
            lib = os.path.join(vdir, f"{kernel}.so")
            cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib,
                   os.path.join(vdir, f"{kernel}.cu")]
            procs.append((variant, kernel, lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    libs = {}
    for variant, kernel, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {variant} {kernel}:\n{log.decode()}")
        symbol, argtypes = build.ENTRY_POINTS[kernel]
        fn = getattr(ctypes.CDLL(lib), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        libs.setdefault(variant, {})[kernel] = fn
    return libs


def _bits(t, torch):
    """A checksum of ``t``'s bits: the sum of every 32- or 16-bit word
    times (its position mod 1,000,003) + 1, in wrapping int64 (the same
    bits give the same sum on any card)."""
    words = t.view(torch.int32 if t.element_size() == 4
                   else torch.int16).reshape(-1)
    total = torch.zeros((), dtype=torch.int64, device=t.device)
    step = 1 << 26
    for lo in range(0, words.numel(), step):
        x = words[lo:lo + step].long()
        w = torch.arange(lo, lo + x.numel(), device=t.device) % 1000003 + 1
        total += (x * w).sum()
    return int(total)


def _gathers_section(cs, root, plans, feats, corner, build, ablate, torch):
    """Rows 5, 4 and 10 of the checkout on the card (``--gathers``) at
    both layers' widths, ``feats[label]`` (F of layer 1, then of layer 2 at
    one head): returns (rows, ablation rows)."""
    from pygat_tpu_torch.ops import banded as bd
    from pygat_tpu_torch.ops import corner as cn
    from pygat_tpu_torch.ops import large as lg

    # a checkout whose one-limb take reads the f32 table (no cast)
    rounds = os.path.exists(os.path.join(root, "pygat_tpu_torch", "csrc",
                                         "take_rows.cuh"))
    variants = _take_ablated(root, build) if ablate else {}
    kw = dict(calls=GATHER_CALLS, replays=GATHER_REPLAYS)
    big = dict(calls=cs.BIG_CALLS, replays=cs.BIG_REPLAYS)
    rows, ablated = [], []

    def timed(row, fn, c_args, n_bytes, kws, out, want, again):
        row["ms"] = cs._time_ms(lambda: _call(fn, c_args, row["kernel"]),
                                **kws)
        row["bound_ms"] = cs._bound(n_bytes, 0)[0]
        torch.cuda.synchronize()
        row["bit_exact"] = bool(torch.equal(out, want))
        row["bitwise_repeat"] = bool(torch.equal(out, again))
        row["bits"] = _bits(out, torch)
        print(f"  {row['kernel']} {row['dataset']} {row['path']} "
              f"L={row['L']}: {row['ms']:.4f} ms" + "".join(
                  f", {k} {row[k]:.4f}" for k in ("wrapper_ms", "cast_ms")
                  if k in row)
              + f", bound {row['bound_ms']:.5f} ms, bit-exact "
              f"{row['bit_exact']}, repeat {row['bitwise_repeat']}, bits "
              f"{row['bits']}", flush=True)
        if not (row["bit_exact"] and row["bitwise_repeat"]):
            print(f"  {row['kernel']} DISAGREES with its plain version or "
                  "itself", flush=True)
        rows.append(row)

    heads = (8, 1)
    for label in ("large", "cora"):
        plan, n_pad = plans[label], plans[label].n_pad
        e, c = plan.num_slots, plan.num_chunks
        tkw = kw if label == "large" else dict(kw, calls=50)
        for path in ("v1", "v2"):
            for h, f in zip(heads, feats[label]):
                hf = h * f
                take_l = hf if path == "v1" else 2 * hf
                gen = torch.Generator(device="cuda")
                gen.manual_seed(take_l)
                table = torch.randn(n_pad, take_l, generator=gen,
                                    device="cuda")
                for kernel in TAKES:
                    one = kernel == "banded_take_bf16"
                    prec = "fastest" if one else "high"
                    row = dict(kernel=kernel, dataset=label, path=path, H=h,
                               F=f, L=take_l)
                    src = table if rounds or not one else table.to(
                        torch.bfloat16)
                    out = torch.empty(e, take_l, device="cuda",
                                      dtype=torch.bfloat16 if one
                                      else torch.float32)
                    c_args = [src.data_ptr(), plan.band.data_ptr(),
                              plan.s_loc.data_ptr(), c, plan.w, take_l,
                              out.data_ptr()]
                    row["wrapper_ms"] = cs._time_ms(
                        lambda: bd.banded_take(table, plan, precision=prec),
                        **(big if label == "large" else {}))
                    if one and not rounds:
                        row["cast_ms"] = cs._time_ms(
                            lambda: table.to(torch.bfloat16), **tkw)
                    want = bd.banded_take_plain(table, plan, precision=prec)
                    again = bd.banded_take(table, plan, precision=prec)
                    fn = build.kernel(kernel)
                    timed(row, fn, c_args,
                          (4 * n_pad + (2 if one else 4) * e) * take_l
                          + 4 * (e + c), tkw, out, want, again)
                    if label == "large" and variants:
                        arow = {"kernel": kernel, "L": take_l, "path": path}
                        for v, fns in variants.items():
                            if kernel not in fns:
                                continue
                            vargs = list(c_args)
                            t16 = None
                            if v == "bf16table":
                                t16 = table.to(torch.bfloat16)
                                vargs[0] = t16.data_ptr()
                                arow["bf16table_cast_ms"] = cs._time_ms(
                                    lambda: table.to(torch.bfloat16), **tkw)
                            out.zero_()
                            arow[f"{v}_ms"] = cs._time_ms(
                                lambda: _call(fns[kernel], vargs, kernel),
                                **tkw)
                            torch.cuda.synchronize()
                            arow[f"{v}_bit_exact"] = bool(torch.equal(out,
                                                                      want))
                            del t16
                        print(f"  take_rows.cuh {kernel} large {path} "
                              f"L={take_l}: base {row['ms']:.4f}, " + ", ".join(
                                  f"{k} {v}" for k, v in arow.items()
                                  if k.endswith("_ms") or
                                  k.endswith("_exact")), flush=True)
                        ablated.append(arow)
                    del out, want, again, src
                    torch.cuda.empty_cache()
                if label != "large":
                    continue
                # row 4 (expand) at the receiver operands' width
                x_l = 3 * h + hf if path == "v1" else 2 * hf + 2 * h
                x = torch.randn(n_pad, x_l, generator=gen, device="cuda")
                out = torch.empty(e, x_l, device="cuda")
                c_args = [x.data_ptr(), plan.r_local.data_ptr(),
                          plan.r_chunk.data_ptr(), c, x_l, out.data_ptr()]
                timed(dict(kernel="expand", dataset=label, path=path, H=h,
                           F=f, L=x_l), build.kernel("expand"), c_args,
                      4 * (n_pad + e) * x_l + 4 * (e + c), tkw, out,
                      lg.expand_plain(x, plan.r_local, plan.r_chunk),
                      lg.expand(x, plan.r_local, plan.r_chunk))
                del x, out, table
                torch.cuda.empty_cache()
    # row 10 (permute_pass) on every pass of the 524k corner plans
    for direction, cplan in (("fwd", corner.fwd), ("inv", corner.inv)):
        for path, width in cs._corner_widths(heads, feats["large"]):
            gen = torch.Generator(device="cuda")
            gen.manual_seed(width)
            src = torch.randn(cplan.n_rows, width, generator=gen,
                              device="cuda")
            for i, cp in enumerate(cplan.passes):
                t = cp.lo.shape[0]
                out = torch.empty(t * 128, width, device="cuda")
                c_args = [src.data_ptr(), cp.lo.data_ptr(), cp.g.data_ptr(),
                          t, cp.p, width, out.data_ptr()]
                timed(dict(kernel="corner_permute", dataset="large",
                           path=f"{path} {direction} pass {i}", L=width),
                      build.kernel("corner_permute"), c_args,
                      4 * (src.shape[0] * width + t * 128 * (width + 1)
                           + t), kw, out, cn.permute_pass_plain(src, cp),
                      cn.permute_pass(src, cp))
                src = out
            del src
            torch.cuda.empty_cache()
    return rows, ablated


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", help="checkout whose kernels are timed")
    ap.add_argument("--tag", required=True, help="name of this run")
    ap.add_argument("--out", default=".", help="directory of the JSON file")
    ap.add_argument("--ablate", action="store_true",
                    help="also time ablated copies of the tile-owner body")
    ap.add_argument("--epochs", action="store_true",
                    help="also time the Cora and 524k fast-loop epochs")
    ap.add_argument("--bcsr", action="store_true",
                    help="time kernel row 11 (bcsr_attention) instead")
    ap.add_argument("--gathers", action="store_true",
                    help="time kernel rows 5, 4 and 10 (the row gathers) "
                    "instead")
    ap.add_argument("--f2", type=int, default=None,
                    help="with --gathers: layer 2's F at 524k (default: "
                    "the graph's classes)")
    a = ap.parse_args()
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("banded_ab: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from pygat_tpu_torch.data.citation import load_citation
    from pygat_tpu_torch.models.gat import GATConfig
    from pygat_tpu_torch.models.presets import PRESETS
    from pygat_tpu_torch.ops import banded as bd
    from pygat_tpu_torch.ops import build
    from pygat_tpu_torch.ops import fused_corner as fc
    from pygat_tpu_torch.ops import fused_stream as fs
    from pygat_tpu_torch.ops.large import plan_csc_to_csr
    from pygat_tpu_torch.tools.profile_epoch import large_config, large_dataset

    if not build.PKG_DIR.startswith(root):
        raise RuntimeError(f"imported {build.PKG_DIR}, not {root}'s package")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs._card_line()
    print(f"banded_ab {a.tag}: {root}; card {card!r}", flush=True)
    t0 = time.perf_counter()
    print(f"  built in {build.build_all():.1f} s", flush=True)
    res = {"tag": a.tag, "root": root, "card": card, "cases": []}
    big = dict(calls=cs.BIG_CALLS, replays=cs.BIG_REPLAYS)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(72)

    large = large_dataset()
    cora = load_citation("cora", device="cuda")
    pubmed = load_citation("pubmed", device="cuda")
    hub = cs._hub_graph()
    graphs = {"large": large.graph, "cora": cora.graph,
              "pubmed": pubmed.graph, "hub": hub}
    plans = {"large": bd.maybe_plan_large(large.graph),
             "cora": bd.build_band_plan(cora.graph, w=4),
             "hub": bd.build_band_plan(hub, w=4)}
    if a.bcsr:
        res["bcsr"], res["bcsr_ablate"] = _bcsr_section(
            cs, root, graphs, large, plans["large"], build, a.ablate, torch)
        for case in res["bcsr"]:
            case.pop("args", None)
        return _finish(res, a, t0)
    corner = plan_csc_to_csr(large.graph)
    if a.gathers:
        res["gathers"], res["gathers_ablate"] = _gathers_section(
            cs, root, plans, {"large": (8, a.f2 or large.num_classes),
                              "cora": (8, cora.num_classes)},
            corner, build, a.ablate, torch)
        if a.epochs:
            res["epoch_ms"] = {}
            for lt in ("GAT_sparse", "GATv2_sparse"):
                samples, _ = cs._large_epoch_ms(
                    large_config(lt, large), large,
                    {"high": plans["large"], "fastest": plans["large"]},
                    {"high": "high", "fastest": "fastest"})
                for k, v in samples.items():
                    res["epoch_ms"][f"large {lt} banded {k} fast_loop_ms"] = v
                    print(f"  524k {lt} band plan, {k}: fast-loop epoch "
                          f"median {v[len(v) // 2]:.4f} ms "
                          f"({[round(x, 4) for x in v]})", flush=True)
        return _finish(res, a, t0)
    wide = ((8, 8), (1, 4), (1, 64), (1, 256))
    # (order, graph label, kernel, shapes)
    specs = (
        [("banded", g, k, wide if g == "large" else
          ((8, 8), (1, 7)) if g == "cora" else ((8, 8),))
         for g in ("large", "cora", "hub") for k in BANDED]
        + [("stream", g, k, wide if g == "large" else
            ((8, 8), (1, 7)) if g == "cora" else ((8, 8),))
           for g in ("large", "cora", "hub") for k in STREAM]
        + [("stream", "pubmed", "fused_v2", ((8, 8), (8, 3)))]
        + [("window", "large", k, ((8, 8), (1, 4)))
           for k in ("fused_v1_window", "fused_v2_window")])
    make = {"fused_v1": cs._fused_inputs, "fused_v2": cs._fused_v2_inputs}

    def inputs(order, label, kernel, h, f):
        """(wrapper, plain, args, keywords) of one case."""
        g = graphs[label]
        v = kernel[:8]  # fused_v1 / fused_v2
        if order == "banded":
            return (getattr(bd, kernel), getattr(bd, kernel + "_plain"),
                    make[v](g, h, f, gen, plans[label]), {})
        args = make[v](g, h, f, gen)
        if order == "window":
            if v == "fused_v1":
                win = fc.gather_corner(args[0], g, corner.fwd)
                args = (win, *args[1:5], *args[6:])
            else:
                win = fc.gather_corner(torch.cat([args[1], args[0]], 1), g,
                                       corner.fwd)
                args = (args[0], win, *args[2:5], *args[6:])
            return (getattr(fc, kernel), getattr(fc, kernel + "_plain"),
                    args, _walk_kw(g))
        return (getattr(fs, kernel), getattr(fs, kernel + "_plain"), args,
                _walk_kw(g))

    def exact(plain):
        """The plain version in f64 where the checkout has that option."""
        return ({"f64": True}
                if "f64" in inspect.signature(plain).parameters else {})

    for order, label, kernel, shapes in specs:
        g = graphs[label]
        src = plans[label] if order == "banded" else g
        live = src.r_local < 128
        n_live = int(live.sum())
        index_words = (2 * src.num_slots + 2 * src.num_chunks
                       if order == "banded" else
                       (2 if order == "stream" else 1) * g.num_edges_padded
                       + g.r_chunk.numel())
        for h, f in shapes:
            wrapper, plain, args, kw = inputs(order, label, kernel, h, f)
            # timed before the checks: after them (the f64 plain version
            # takes GBs at 524k), a call through the wrapper took up to
            # 0.06 ms more than the same kernel launched on fixed outputs
            row = dict(order=order, dataset=label, kernel=kernel, H=h, F=f)
            row["ms"] = cs._time_ms(lambda: wrapper(*args, **kw),
                                    **(big if label == "large" else {}))
            got = wrapper(*args, **kw)
            if f <= 64:
                want = plain(*args, **exact(plain))
                torch.cuda.synchronize()
                errs = [cs._max_err(g_, w_) for g_, w_ in zip(got, want)]
                row["max_abs_err"] = max(e for e, _ in errs)
                row["within_tolerance"] = all(e <= al for e, al in errs)
                if not row["within_tolerance"]:
                    print(f"  {kernel} {label} H {h} F {f} DISAGREES with "
                          f"its plain version: {errs}", flush=True)
                if exact(plain):
                    # the kernel's and the float32 plain version's errors
                    # against the float64 one, relative to max(1, max |out|)
                    f32 = plain(*args)
                    scale = [max(1.0, float(w_.abs().max())) for w_ in want]
                    row["rel_err"] = max(e / s_ for (e, _), s_ in
                                         zip(errs, scale))
                    row["plain_f32_rel_err"] = max(
                        float((p_ - w_).abs().max()) / s_
                        for p_, w_, s_ in zip(f32, want, scale))
                    print(f"  {kernel} {label} H {h} F {f}: against the "
                          f"plain version in f64, kernel {row['rel_err']:.2e}"
                          f", plain in f32 {row['plain_f32_rel_err']:.2e}",
                          flush=True)
                    del f32
                del want
            again = wrapper(*args, **kw)
            row["bitwise_repeat"] = all(
                torch.equal(x, y) for x, y in zip(got, again))
            del got, again
            row["bound_ms"] = _bound_ms(cs, kernel, g.num_nodes_padded, h, f,
                                        n_live, index_words)
            if (a.ablate and label == "large" and (h, f) == (8, 8)
                    and order != "window"):
                row["args"] = args
            print(f"  {kernel} {label} ({order}) H {h} F {f}: "
                  f"{row['ms']:.4f} ms, bound {row['bound_ms']:.5f} ms, error "
                  f"{row.get('max_abs_err', float('nan')):.3e}, bitwise "
                  f"repeat {row['bitwise_repeat']}", flush=True)
            res["cases"].append(row)
            del args
            torch.cuda.empty_cache()
    res["large_forward_ms"] = {
        c["kernel"]: 0.0 for c in res["cases"] if c["dataset"] == "large"}
    for c in res["cases"]:
        if c["dataset"] == "large" and (c["H"], c["F"]) in ((8, 8), (1, 4)):
            res["large_forward_ms"][c["kernel"]] += c["ms"]
    print("  524k forward (both launches): " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in res["large_forward_ms"].items()),
        flush=True)

    if a.ablate:
        kernels = BANDED + (STREAM if _stream_on_body(root) else ())
        libs = _ablated_libs(root, build, kernels)
        res["ablate"] = []
        for case in res["cases"]:
            args = case.pop("args", None)
            if args is None or case["kernel"] not in kernels:
                continue
            kernel = case["kernel"]
            c_args, _ = _c_args(kernel, args, large.graph, torch)
            row = {"kernel": kernel, "H": case["H"], "F": case["F"]}
            for variant, fn in [("base", build.kernel(kernel))] + [
                    (v, fns[kernel]) for v, fns in libs.items()]:
                row[f"{variant}_ms"] = cs._time_ms(
                    lambda: _call(fn, c_args, kernel), **big)
            print(f"  tile_fused.cuh {kernel} large H {case['H']} F "
                  f"{case['F']}: " + ", ".join(
                      f"{k} {v:.4f}" for k, v in row.items()
                      if k.endswith("_ms")), flush=True)
            res["ablate"].append(row)
            del args, c_args
            torch.cuda.empty_cache()
    for case in res["cases"]:
        case.pop("args", None)

    if a.epochs:
        res["epoch_ms"] = {}
        for lt in ("GAT_sparse", "GATv2_sparse"):
            cfg = GATConfig(layer_type=lt, **PRESETS["cora"])
            cfg = cfg._replace(nfeats=(int(cora.features.shape[1]),)
                               + cfg.nfeats[1:])
            _, fast = cs._epoch_ms(cfg, cora)
            res["epoch_ms"][f"cora {lt} fast_loop_ms"] = fast
            print(f"  Cora {lt} fast-loop epoch: median "
                  f"{fast[len(fast) // 2]:.4f} ms ({fast})", flush=True)
        bd.set_band("off")
        stream_plan = bd.maybe_plan_large(large.graph)
        bd.set_band("auto")
        for lt in ("GAT_sparse", "GATv2_sparse"):
            samples, peak = cs._large_epoch_ms(
                large_config(lt, large), large,
                {"banded": plans["large"], "corner": corner,
                 "stream": stream_plan})
            for k, v in samples.items():
                res["epoch_ms"][f"large {lt} {k} fast_loop_ms"] = v
                print(f"  524k {lt} {k} fast-loop epoch: median "
                      f"{v[len(v) // 2]:.4f} ms ({[round(x, 4) for x in v]})",
                      flush=True)

    return _finish(res, a, t0)


def _finish(res, a, t0) -> int:
    """Write the results; 1 if a case disagreed with its plain version."""
    print(f"  {time.perf_counter() - t0:.1f} s", flush=True)
    os.makedirs(a.out, exist_ok=True)
    with open(os.path.join(a.out, f"banded_ab_{a.tag}.json"), "w") as f:
        json.dump(res, f, indent=1)
    return int(not all(c.get("within_tolerance", True)
                       for c in res["cases"] + res.get("bcsr", []))
               or not all(c["bit_exact"] and c["bitwise_repeat"]
                          for c in res.get("gathers", [])))


if __name__ == "__main__":
    sys.exit(main())
