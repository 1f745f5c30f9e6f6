"""Time the SpMM kernels of one checkout of this repository on the card, for
an A/B of two commits in one call (parent, change, change, parent):

    python pygat_tpu_torch/tools/spmm_ab.py ROOT --tag NAME [--ablate]

``ROOT`` is a checkout of the repository (for the parent, a ``git archive``
unpacked into a directory that ``.gitignore`` lists). The script imports
``ROOT``'s ``pygat_tpu_torch`` and ``chip_smoke.py``, builds ``ROOT``'s
kernels into ``ROOT``'s own build directory, and runs ``ROOT``'s phase 6
(``_spmm_graphs``, ``_spmm_kernel_cases``, ``_time_spmm``) on the Pubmed
stand-in and the 524k clustered graph at L = 128: each SpMM kernel held
against its plain version, then timed beside it, ``torch.sparse.mm`` and its
bound. Beside them, ``stream_scatter`` at Cora's four GAT_sparse and four
GATv2_sparse backward shapes (``chip_smoke._scatter_cases``).

``--ablate`` also builds altered copies of the body that ``ROOT``'s SpMM
kernels include and times each at the 524k shapes, to split the kernels'
time into phases. Of the block-per-chunk body (``csrc/stream_scatter.cuh``),
which the SpMM kernels of a checkout from before the tile-owner body
include; these ablations, the block-per-chunk arguments of ``_body_args``
and the missing hub case are what lets the tool measure such a checkout,
the parent of an A/B against the tile-owner body (PERF.md's old-body phase
shares come from them):

* ``store``: the drain adds the accumulator into the output with plain
  stores instead of one global atomic per element (a wrong result);
* ``noload``: the window is filled with the slot's row index instead of a
  load of its row of x (a wrong result);
* ``noload_store``: both;
* ``slab32``: 32 columns per block instead of 64 (the same result).

Of the tile-owner body (``csrc/tile_spmm.cuh``): ``noload`` (the slot's
row index in place of its row of x), ``noadd`` (every slot summed into one
register run, no shared-memory adds; both wrong results), ``two_blocks``
(two blocks per SM, up to 128 registers a thread), ``batch16`` (16 rows in
flight per warp, two blocks per SM; the same result), ``red``
(a row's adds by shared-memory atomics) and ``carveout`` (all of the SM's
configurable memory as shared memory). Beside them
``zero_ms``, the time of zeroing the output (``Tensor.zero_``; the first
body's launcher does it with ``cudaMemsetAsync``), and ``base_L64_ms``, the
unaltered kernel at L = 64. Device times come
from ``chip_smoke._time_ms`` (calls captured in a CUDA graph and replayed
between CUDA events). The results go to ``OUT/spmm_ab_NAME.json`` (``--out``,
by default the current directory) and, one line per number, to standard
output.
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

# per body (the header both SpMM kernels include): text -> its ablated form,
# each found exactly once
_ABLATIONS = {
    # the block-per-chunk body
    "stream_scatter.cuh": {
        "store": [(r"atomicAdd\(&o\[(static_cast<long long>\(r\) \* L \+ "
                   r"\(i - r \* cols\))\], acc\[i\]\);", r"o[\1] = acc[i];")],
        "noload": [(r"v\[u\] = __ldg\(data \+ static_cast<long long>"
                    r"\(s_row\[k\]\) \* L \+ c0 \+\s*\(i - k \* cols\)\);",
                    "v[u] = static_cast<float>(s_row[k]);")],
        # 48 KB of dynamic shared memory plus the static arrays pass the
        # default limit: opt in at every size
        "slab32": [(r"constexpr int MAX_SLAB = 64;",
                    "constexpr int MAX_SLAB = 32;"),
                   (r"if \(smem(?: \+ sizeof\(int\) \* \(2 \* EC \+ 2\))? > "
                    r"48 \* 1024\) \{", "if (smem > 0) {")],
    },
    # the tile-owner body
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
}
_ABLATIONS["stream_scatter.cuh"]["noload_store"] = (
    _ABLATIONS["stream_scatter.cuh"]["noload"]
    + _ABLATIONS["stream_scatter.cuh"]["store"])


def _body(root):
    """The header of ``root``'s SpMM kernels' body."""
    csrc = os.path.join(root, "pygat_tpu_torch", "csrc")
    return ("tile_spmm.cuh" if os.path.exists(os.path.join(csrc,
                                                           "tile_spmm.cuh"))
            else "stream_scatter.cuh")


def _ablated_libs(root, build):
    """Build spmm_banded.cu and panel_spmm.cu of ``root`` against each
    ablated copy of their body, all nvcc processes at once; returns
    {variant: {kernel: ctypes function}}."""
    csrc = os.path.join(root, "pygat_tpu_torch", "csrc")
    header = _body(root)
    with open(os.path.join(csrc, header)) as f:
        body = f.read()
    out_dir = os.path.join(root, "pygat_tpu_torch", "_build", "ablate")
    procs = []
    for variant, subs in _ABLATIONS[header].items():
        vdir = os.path.join(out_dir, variant)
        shutil.rmtree(vdir, ignore_errors=True)
        shutil.copytree(csrc, vdir)
        # each pattern alters the body or one kernel's source, once
        texts = {header: body}
        for name in ("spmm_banded.cu", "panel_spmm.cu"):
            with open(os.path.join(csrc, name)) as f:
                texts[name] = f.read()
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
        for kernel in ("spmm_banded", "panel_spmm"):
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


def _body_args(item, x, tile_owner, torch):
    """(C arguments up to the stream, output) of a 524k case for the SpMM
    entry points: the block-per-chunk ones or the tile-owner ones."""
    inp = item["inp"]
    n_pad, width = x.shape
    out = torch.empty(n_pad, width, device="cuda")
    if item["kernel"] == "spmm_banded":
        plan = item["plan"]
        if tile_owner:
            n_split = plan.split_at.numel()
            part = torch.empty(max(n_split, 1), 128, width, device="cuda")
            walk = plan.spmm_walk
            args = (inp["vals_b"], x, walk.rows, walk.local, walk.order,
                    plan.tile_ptr, plan.split_at,
                    n_pad // 128, n_split, width, out, part)
        else:
            args = (inp["vals_b"], x, plan.band, plan.s_loc, plan.r_local,
                    plan.r_chunk, plan.num_chunks, n_pad // 128, plan.w,
                    width, out)
    else:
        g, lay = item["graph"], item["layout"]
        if tile_owner:
            n_split = lay.split_at.numel()
            part = torch.empty(max(n_split, 1), 128, width, device="cuda")
            args = (inp["w"], g.edge_mask, x, lay.panel_tiles, lay.g_idx,
                    g.r_local, g.r_chunk, lay.tile_ptr, lay.split_at,
                    n_pad // 128, n_split, lay.n_panels, width, out, part)
        else:
            args = (inp["w"], g.edge_mask, x, lay.panel_tiles, lay.g_idx,
                    g.r_local, g.r_chunk, g.r_chunk.shape[0], n_pad // 128,
                    lay.n_panels, width, out)
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    return c_args, out


def _call(fn, c_args, kernel):
    """Launch a kernel library's entry point on the current stream (inside a
    CUDA-graph capture, the capturing one)."""
    import torch

    rc = fn(*c_args, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"{kernel}: CUDA error {rc} at launch")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", help="checkout whose kernels are timed")
    ap.add_argument("--tag", required=True, help="name of this run")
    ap.add_argument("--out", default=".", help="directory of the JSON file")
    ap.add_argument("--ablate", action="store_true",
                    help="also time ablated copies of the block-per-chunk "
                         "body")
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
    from pygat_tpu_torch.ops.stream import stream_scatter
    from pygat_tpu_torch.tools.profile_epoch import large_dataset

    if not build.PKG_DIR.startswith(root):
        raise RuntimeError(f"imported {build.PKG_DIR}, not {root}'s package")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs._card_line()
    print(f"spmm_ab {a.tag}: {root}; card {card!r}", flush=True)
    t0 = time.perf_counter()
    print(f"  built in {build.build_all():.1f} s", flush=True)
    res = {"tag": a.tag, "root": root, "card": card}

    # stream_scatter at Cora's backward shapes (row 1, which must not move)
    cora = load_citation("cora", device="cuda")
    g = cora.graph
    gen = torch.Generator(device="cuda")
    gen.manual_seed(72)
    heads, feats = PRESETS["cora"]["nheads"], PRESETS["cora"]["nfeats"][1:]
    sums = {}
    for case in cs._scatter_cases("cora", g, heads, feats, gen):
        ms = cs._time_ms(lambda: cs._scatter_call(case, g, stream_scatter))
        sums[case["path"]] = sums.get(case["path"], 0.0) + ms
    res["stream_scatter_cora_ms"] = sums
    print(f"  stream_scatter, Cora, one step's 4 launches: GAT_sparse "
          f"{sums['v1']:.4f} ms, GATv2_sparse {sums['v2']:.4f} ms", flush=True)

    pubmed = load_citation("pubmed", device="cuda")
    large = large_dataset()
    plan = maybe_plan_large(large.graph)
    specs, _ = cs._spmm_graphs(pubmed, large, plan, None)
    if hasattr(cs, "_hub_spec"):  # a checkout before the tile-owner body
                                  # has no hub case
        specs["hub"] = cs._hub_spec()
    inputs = {label: cs._spmm_inputs(spec["graph"], 17 + i)
              for i, (label, spec) in enumerate(specs.items())}
    for label, spec in specs.items():  # values in banded order
        if spec["band"] is not None:
            perm = torch.from_numpy(spec["band"].perm).to("cuda")
            inputs[label]["vals_b"] = torch.where(
                perm >= 0, inputs[label]["w"][perm.clamp(min=0)], 0.0)
    cases = cs._spmm_kernel_cases(specs, inputs)
    res["cases"] = []
    for case in cases:
        cs._time_spmm(case)
        res["cases"].append(case)

    if a.ablate:
        libs = _ablated_libs(root, build)
        tile_owner = _body(root) == "tile_spmm.cuh"
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
            c_args, out = _body_args(item, x, tile_owner, torch)
            row = {"kernel": kernel, "shape": item["shape"]}
            for variant, fn in [("base", build.kernel(kernel))] + [
                    (v, fns[kernel]) for v, fns in libs.items()]:
                row[f"{variant}_ms"] = cs._time_ms(
                    lambda: _call(fn, c_args, kernel), **big)
            row["zero_ms"] = cs._time_ms(out.zero_, **big)
            c64, _ = _body_args(item, x64, tile_owner, torch)
            row["base_L64_ms"] = cs._time_ms(
                lambda: _call(build.kernel(kernel), c64, kernel), **big)
            print(f"  {_body(root)} {kernel} {item['shape']}: " + ", ".join(
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
