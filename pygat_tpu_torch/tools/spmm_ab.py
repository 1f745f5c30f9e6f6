"""Time the SpMM kernels and the segment sums of one checkout of this
repository on the card, for an A/B of two commits in one call (parent,
change, change, parent):

    python pygat_tpu_torch/tools/spmm_ab.py ROOT --tag NAME [--ablate]

``ROOT`` is a checkout of the repository (for the parent, a ``git archive``
unpacked into a directory that ``.gitignore`` lists). The script imports
``ROOT``'s ``pygat_tpu_torch`` and ``chip_smoke.py``, builds ``ROOT``'s
kernels into ``ROOT``'s own build directory, and times, through ``ROOT``'s
own wrappers and ``chip_smoke`` helpers:

* the segment sums, kernel rows 1 (``stream_scatter``) and 6
  (``banded_sender_sum``), at the shapes one train step of each model
  gives them (``chip_smoke._scatter_cases``, ``_banded_cases``): the
  receiver stream and its CSC side on Cora, on the 524k clustered graph
  (the order ``set_band("off")`` trains over) and on the hub graph
  (``chip_smoke._hub_graph``, its dummy sender's run long), and the 524k
  band plan (``maybe_plan_large``), each launch beside ``index_add_`` of
  the same sums and its bound (chip_smoke's: bytes of the function over
  the memory rate), and summed per step;
* the SpMM kernels, ``ROOT``'s phase 6 (``_spmm_graphs``,
  ``_spmm_kernel_cases``, ``_time_spmm``) on the Pubmed stand-in, the 524k
  clustered graph and the hub graph at L = 128: each held against its
  plain version, then timed beside it, ``torch.sparse.mm`` and its bound.

``--ablate`` also builds altered copies of the tile-owner bodies and times
each at the 524k shapes, to split the kernels' time into phases. Of the
SpMM body (``csrc/tile_spmm.cuh``): ``noload`` (the slot's row index in
place of its row of x), ``noadd`` (every slot summed into one register
run, no shared-memory adds; both wrong results), ``two_blocks`` (two
blocks per SM, up to 128 registers a thread), ``batch16`` (16 rows in
flight per warp, two blocks per SM; the same result), ``red`` (a row's adds
by shared-memory atomics) and ``carveout`` (all of the SM's configurable
memory as shared memory); beside them ``zero_ms``, the time of zeroing the
output (``Tensor.zero_``), and ``base_L64_ms``, the unaltered kernel at L =
64. Of the segment-sum body (``csrc/tile_sum.cuh``), at every launch
of both kernels: ``noload`` (the row word in place of the data row),
``norows`` (position k's data row k, no row word: both wrong results; not
where the walk has more positions than data rows), ``nosplit`` (no cut of
long runs: one unit walks a hub's or the dummy sender's run alone),
``batch2`` and ``batch8`` (2 or 8 positions in flight instead of 4),
``threads128`` (blocks of at most 128 threads where runs are not cut),
``split256`` (blocks of up to 256 threads where they are), ``seg32``
(segments of at least 32 positions instead of 8), ``nocombine`` (no
combine of a cut tile's pieces: a wrong result there), ``combine8`` (the
combine's loads 8 pieces at a time instead of 16) and ``nopieces`` (a cut
tile walked whole; all but ``noload``, ``norows`` and ``nocombine`` give
the same result). Device
times come from ``chip_smoke._time_ms`` (calls captured in a CUDA graph
and replayed between CUDA events). The results go to
``OUT/spmm_ab_NAME.json`` (``--out``, by default the current directory)
and, one line per number, to standard output.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time

# per body: text -> its ablated form, each found exactly once in the body
# or in one of its kernels' sources
_ABLATIONS = {
    "tile_spmm.cuh": {
        # the slot's row index in place of its row of x
        "noload": [(r"load_row<kVec>\(x \+ static_cast<long long>\(r\) \* L "
                    r"\+ c0, lane, cols,\s*v\[u\]\);",
                    "v[u][0] = v[u][1] = v[u][2] = v[u][3] = "
                    "__int_as_float(r);")],
        # every slot summed into one register run: no shared-memory adds
        "noadd": [(r"if \(lu\[u\] != cur\) \{", "if (cur < 0) {")],
        # two blocks of up to 128 registers a thread per SM
        "two_blocks": [(r"__launch_bounds__\(TS_WARPS \* 32, 3\)",
                        "__launch_bounds__(TS_WARPS * 32, 2)")],
        # 16 rows in flight per warp, two blocks per SM
        "batch16": [(r"constexpr int TS_BATCH = 8;",
                     "constexpr int TS_BATCH = 16;"),
                    (r"__launch_bounds__\(TS_WARPS \* 32, 3\)",
                     "__launch_bounds__(TS_WARPS * 32, 2)")],
        # a row's adds by shared-memory atomics without return (RED)
        "red": [(r"float4\* p = reinterpret_cast<float4\*>\(a\) \+ lane;\s*"
                 r"float4 t = \*p;\s*t\.x \+= s\[0\];\s*t\.y \+= s\[1\];\s*"
                 r"t\.z \+= s\[2\];\s*t\.w \+= s\[3\];\s*\*p = t;",
                 "float* p = a + 4 * lane;\n"
                 "#pragma unroll\n"
                 "      for (int q = 0; q < 4; ++q) atomicAdd(p + q, s[q]);")],
        # the whole of the SM's configurable memory as shared memory
        "carveout": [(r"  dim3 grid\(n_tiles \+ n_split",
                      "  cudaFuncSetAttribute(kernel, "
                      "cudaFuncAttributePreferredSharedMemoryCarveout, 100);"
                      "\n  dim3 grid(n_tiles + n_split")],
    },
    "tile_sum.cuh": {
        # the row word in place of the data row
        "noload": [(r"load_cols<C, kVec>\(p\.data \+ static_cast<long long>"
                    r"\(r\[u\]\) \* p\.L \+ col,\s*u < n \? nf : 0, v\[u\]\);",
                    "for (int i = 0; i < C; ++i) v[u][i] = "
                    "__int_as_float(r[u]);")],
        # position k's data row k: no row word
        "norows": [(r"\(p\.rows \? __ldg\(p\.rows \+ k0 \+ u\) : k0 \+ u\)",
                    "(k0 + u)")],
        # no cut of long runs
        "nosplit": [(r"const bool split = max_run > TS_SPLIT;",
                     "const bool split = false;")],
        "batch2": [(r"constexpr int TS_BATCH = 4;",
                    "constexpr int TS_BATCH = 2;")],
        "batch8": [(r"constexpr int TS_BATCH = 4;",
                    "constexpr int TS_BATCH = 8;")],
        "threads128": [(r"constexpr int TS_THREADS = 256;",
                        "constexpr int TS_THREADS = 128;")],
        # blocks of up to 256 threads in kSplit too
        "split256": [(r"constexpr int TS_SPLIT_THREADS = 128;",
                      "constexpr int TS_SPLIT_THREADS = 256;")],
        # no combine of a cut tile's pieces (a wrong result there)
        "nocombine": [(r"return launch_tile_combine\(p\.tile_ptr",
                       "return 0; (void)launch_tile_combine(p.tile_ptr")],
        # the combine's loads 8 pieces at a time
        "combine8": [(r"constexpr int PIECE_BATCH = 16;",
                      "constexpr int PIECE_BATCH = 8;")],
        # segments of at least 32 positions
        "seg32": [(r"constexpr int TS_SEG = 8;", "constexpr int TS_SEG = 32;")],
        # a cut tile walked whole, as one piece (the same result)
        "nopieces": [(r"  const cudaStream_t st = static_cast<cudaStream_t>"
                      r"\(stream\);\n  const int width",
                      "  const cudaStream_t st = static_cast<cudaStream_t>"
                      "(stream);\n  p.n_split = 0;\n  const int width")],
    },
}
# the kernels built on each body
_KERNELS = {"tile_spmm.cuh": ("spmm_banded", "panel_spmm"),
            "tile_sum.cuh": ("stream_scatter", "banded_sender_sum")}
SUMS = ("stream_scatter", "banded_sender_sum")


def _ablated_libs(root, build, header):
    """Build the kernels of ``root`` on the body ``header`` against each
    ablated copy of it (or of the tile ranges' header, tile_pieces.cuh),
    all nvcc processes at once; returns {variant: {kernel: ctypes
    function}}."""
    csrc = os.path.join(root, "pygat_tpu_torch", "csrc")
    with open(os.path.join(csrc, header)) as f:
        body = f.read()
    out_dir = os.path.join(root, "pygat_tpu_torch", "_build", "ablate",
                           header.split(".")[0])
    kernels = _KERNELS[header]
    procs = []
    for variant, subs in _ABLATIONS[header].items():
        vdir = os.path.join(out_dir, variant)
        shutil.rmtree(vdir, ignore_errors=True)
        shutil.copytree(csrc, vdir)
        # each pattern alters the body or one kernel's source, once
        texts = {header: body}
        with open(os.path.join(csrc, "tile_pieces.cuh")) as f:
            texts["tile_pieces.cuh"] = f.read()
        for name in kernels:
            with open(os.path.join(csrc, f"{name}.cu")) as f:
                texts[f"{name}.cu"] = f.read()
        for pattern, repl in subs:
            hits = 0
            for name, text in texts.items():
                texts[name], n = re.subn(pattern, repl, text)
                hits += n
            if hits != 1:
                raise RuntimeError(f"{variant}: {pattern!r} matched {hits} "
                                   "times")
        for name, text in texts.items():
            with open(os.path.join(vdir, name), "w") as f:
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


def _body_args(item, x, torch):
    """(C arguments up to the stream, output) of a 524k case for the SpMM
    entry points."""
    inp = item["inp"]
    n_pad, width = x.shape
    out = torch.empty(n_pad, width, device="cuda")
    if item["kernel"] == "spmm_banded":
        plan = item["plan"]
        n_split = plan.split_at.numel()
        part = torch.empty(max(n_split, 1), 128, width, device="cuda")
        walk = plan.spmm_walk
        args = (inp["vals_b"], x, walk.rows, walk.local, walk.order,
                plan.tile_ptr, plan.split_at, n_pad // 128, n_split, width,
                out, part)
    else:
        g, lay = item["graph"], item["layout"]
        n_split = lay.split_at.numel()
        part = torch.empty(max(n_split, 1), 128, width, device="cuda")
        args = (inp["w"], g.edge_mask, x, lay.panel_tiles, lay.g_idx,
                g.r_local, g.r_chunk, lay.tile_ptr, lay.split_at,
                n_pad // 128, n_split, lay.n_panels, width, out, part)
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    return c_args, out


def _sum_args(data, rows, walk, n_pad, torch):
    """(C arguments up to the stream, output) of a segment sum's entry
    point over ``walk`` (the tile-owner body's)."""
    width, n_split = data.shape[1], walk.split_at.numel()
    out = torch.empty(n_pad, width, device="cuda")
    part = torch.empty(max(n_split, 1), 128, width, device="cuda")
    args = (data, rows, walk.row_ptr, walk.tile_ptr, walk.split_at,
            n_pad // 128, n_split, walk.max_run, width, out, part)
    return [a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args], out


def _call(fn, c_args, kernel):
    """Launch a kernel library's entry point on the current stream (inside a
    CUDA-graph capture, the capturing one)."""
    import torch

    rc = fn(*c_args, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"{kernel}: CUDA error {rc} at launch")


def _segment_sums(cs, graphs, plan, ablate_libs, build, torch):
    """Rows 1 and 6 at one train step's shapes of both models on each of
    ``graphs`` (stream order, both sides) and on the 524k ``plan``: device
    ms of the kernel and of ``index_add_`` into a zeroed buffer with a
    scratch row for the dead slots, and the bound; with ``ablate_libs``
    (524k only) the ablated bodies' ms. Returns the rows and the sums per
    step."""
    from pygat_tpu_torch.models.presets import PRESETS
    from pygat_tpu_torch.ops import banded as bd
    from pygat_tpu_torch.ops.stream import stream_scatter

    gen = torch.Generator(device="cuda")
    gen.manual_seed(72)
    big = dict(calls=cs.BIG_CALLS, replays=cs.BIG_REPLAYS)
    heads = PRESETS["cora"]["nheads"]
    rows = []

    def timed(row, run, idx, data, n_out, n_live, idx_words, kw, ablate):
        width = data.shape[1]
        row["ms"] = cs._time_ms(run, **kw)
        lib_out = torch.zeros(n_out + 1, width, device="cuda")
        row["library_ms"] = cs._time_ms(
            lambda: lib_out.index_add_(0, idx, data), **kw)
        row["bound_ms"] = cs._bound(
            4 * (n_live * width + idx_words + n_out * width),
            n_live * width)[0]
        if ablate is not None:
            fn_rows, walk = ablate
            c_args, _ = _sum_args(data, fn_rows, walk, n_out, torch)
            # norows reads data row k for position k: only where the walk
            # has no more positions than data rows
            n_pos = int(walk.row_ptr[-1])
            for variant, fn in [("base", build.kernel(row["kernel"]))] + [
                    (v, fns[row["kernel"]]) for v, fns in
                    ablate_libs.items()
                    if v != "norows" or n_pos <= data.shape[0]]:
                row[f"{variant}_ms"] = cs._time_ms(
                    lambda: _call(fn, c_args, row["kernel"]), **kw)
        print(f"  {row['kernel']} {row['dataset']} {row['order']} "
              f"{row['path']} L={width}: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in row.items()
                  if k == "ms" or k.endswith("_ms")), flush=True)
        rows.append(row)

    for label, (g, feats) in graphs.items():
        kw = big if label == "large" else {}
        hs = heads[:len(feats)]
        n_pad = g.num_nodes_padded
        recv_idx = torch.where(g.r_local < 128,
                               g.r_chunk.long().repeat_interleave(256) * 128
                               + g.r_local.long(), n_pad)
        for case in cs._scatter_cases(label, g, hs, feats, gen):
            recv = case["side"] == "recv"
            ablate = None
            if ablate_libs is not None:
                ablate = ((None, g.stream_walk) if recv
                          else (g.c_slot, g.sender_walk))
            timed(dict(kernel="stream_scatter", dataset=label,
                       order="stream " + case["side"], path=case["path"]),
                  lambda: cs._scatter_call(case, g, stream_scatter),
                  recv_idx if recv else g.senders.long(), case["data"],
                  n_pad, case["n_live"],
                  g.r_local.numel() + g.r_chunk.numel()
                  + (0 if recv else g.c_slot.numel()), kw, ablate)
            del case["data"]
        del recv_idx
        torch.cuda.empty_cache()
    g, feats = graphs["large"]
    for case in cs._banded_cases("large", g, plan, heads, feats, gen):
        if case["kernel"] not in SUMS:
            continue
        recv = case["kernel"] == "stream_scatter"
        ablate = None
        if ablate_libs is not None:
            walk = (bd._receiver_walk("stream_scatter", plan) if recv
                    else plan.sender_walk)
            ablate = (walk.order, walk)
        timed(dict(kernel=case["kernel"], dataset="large", order="band plan",
                   path=case["path"]),
              lambda: cs._banded_call(case, plan),
              cs._slot_rows(plan, "recv" if recv else "send"), case["data"],
              plan.n_pad, case["n_live"],
              plan.num_slots + plan.num_chunks, big, ablate)
    torch.cuda.empty_cache()
    steps = {}
    for r in rows:
        key = f"{r['kernel']} {r['dataset']} {r['order'].split()[0]} {r['path']}"
        for k in ("ms", "library_ms", "bound_ms"):
            steps.setdefault(key, {}).setdefault(k, 0.0)
            steps[key][k] += r[k]
    for key, v in steps.items():
        print(f"  one step, {key}: " + ", ".join(
            f"{k} {x:.4f}" for k, x in v.items()), flush=True)
    return rows, steps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", help="checkout whose kernels are timed")
    ap.add_argument("--tag", required=True, help="name of this run")
    ap.add_argument("--out", default=".", help="directory of the JSON file")
    ap.add_argument("--ablate", action="store_true",
                    help="also time ablated copies of the tile-owner bodies")
    a = ap.parse_args()
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("spmm_ab: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from pygat_tpu_torch.data.citation import load_citation
    from pygat_tpu_torch.models.presets import PRESETS
    from pygat_tpu_torch.ops import build
    from pygat_tpu_torch.ops.banded import maybe_plan_large
    from pygat_tpu_torch.tools.profile_epoch import large_dataset

    if not build.PKG_DIR.startswith(root):
        raise RuntimeError(f"imported {build.PKG_DIR}, not {root}'s package")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs._card_line()
    print(f"spmm_ab {a.tag}: {root}; card {card!r}", flush=True)
    t0 = time.perf_counter()
    print(f"  built in {build.build_all():.1f} s", flush=True)
    res = {"tag": a.tag, "root": root, "card": card}
    libs = {header: _ablated_libs(root, build, header)
            for header in _ABLATIONS} if a.ablate else {}

    cora = load_citation("cora", device="cuda")
    pubmed = load_citation("pubmed", device="cuda")
    large = large_dataset()
    plan = maybe_plan_large(large.graph)
    hub = cs._hub_graph()
    graphs = {"cora": (cora.graph, PRESETS["cora"]["nfeats"][1:]),
              "large": (large.graph, (PRESETS["cora"]["nfeats"][1],
                                      large.num_classes)),
              "hub": (hub, PRESETS["cora"]["nfeats"][1:2])}
    res["sums"], res["sums_per_step"] = _segment_sums(
        cs, graphs, plan, libs.get("tile_sum.cuh"), build, torch)

    specs, _ = cs._spmm_graphs(pubmed, large, plan, None)
    specs["hub"] = cs._hub_spec()
    inputs = {label: cs._spmm_inputs(spec["graph"], 17 + i)
              for i, (label, spec) in enumerate(specs.items())}
    for label, spec in specs.items():  # values in banded order
        if spec["band"] is not None:
            inputs[label]["vals_b"], _ = cs._banded_values(
                spec["band"], inputs[label]["w"])
    cases = cs._spmm_kernel_cases(specs, inputs)
    res["cases"] = []
    for case in cases:
        cs._time_spmm(case)
        res["cases"].append(case)

    if a.ablate:
        res["ablate"] = []
        big = dict(calls=cs.BIG_CALLS, replays=cs.BIG_REPLAYS)
        spec = specs["large"]
        x = inputs["large"]["x"]
        x64 = x[:, :64].contiguous()
        todo = [dict(kernel="spmm_banded", shape="band plan",
                     plan=spec["band"])]
        todo += [dict(kernel="panel_spmm", shape=name, graph=spec["graph"],
                      layout=lay) for name, lay in spec["layouts"].items()]
        for item in todo:
            item["inp"] = inputs["large"]
            kernel = item["kernel"]
            c_args, out = _body_args(item, x, torch)
            row = {"kernel": kernel, "shape": item["shape"]}
            for variant, fn in [("base", build.kernel(kernel))] + [
                    (v, fns[kernel])
                    for v, fns in libs["tile_spmm.cuh"].items()]:
                row[f"{variant}_ms"] = cs._time_ms(
                    lambda: _call(fn, c_args, kernel), **big)
            row["zero_ms"] = cs._time_ms(out.zero_, **big)
            c64, _ = _body_args(item, x64, torch)
            row["base_L64_ms"] = cs._time_ms(
                lambda: _call(build.kernel(kernel), c64, kernel), **big)
            print(f"  tile_spmm.cuh {kernel} {item['shape']}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in row.items()
                if k.endswith("_ms")), flush=True)
            res["ablate"].append(row)
            del out

    print(f"  {time.perf_counter() - t0:.1f} s", flush=True)
    os.makedirs(a.out, exist_ok=True)
    with open(os.path.join(a.out, f"spmm_ab_{a.tag}.json"), "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
