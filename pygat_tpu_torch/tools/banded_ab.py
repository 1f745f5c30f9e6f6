"""Time the fused banded forwards (kernel row 8) of one checkout of this
repository on the card, for an A/B of two commits in one call (parent,
change, change, parent):

    python pygat_tpu_torch/tools/banded_ab.py ROOT --tag NAME [--out DIR] [--ablate]

``ROOT`` is a checkout of the repository (for the parent, a ``git archive``
unpacked into a directory that ``.gitignore`` lists). The script imports
``ROOT``'s ``pygat_tpu_torch`` and ``chip_smoke.py``, builds ``ROOT``'s
kernels into ``ROOT``'s own build directory, and times ``fused_v1_banded``
and ``fused_v2_banded`` through their wrappers, each call first held
against its plain version (``chip_smoke.KERNEL_RTOL`` of the largest
output), at:

* the 524k clustered graph's band plan (``maybe_plan_large``): both
  layers' shapes of both models (H 8 F 8, H 1 F 4), whose sum is one
  forward, and H 1 F 64 and H 1 F 256 (at F 256 the plain version, some
  30 GB of gathers, is not run; the GPU tests hold that width);
* Cora's band plan (``set_band("on")``, w = 4): H 8 F 8 and H 1 F 7;
* the hub graph's band plan (``chip_smoke._hub_graph``, w = 4, its hub
  tile cut into pieces): H 8 F 8;

each beside its bound (``chip_smoke``'s: bytes of the function over the
memory rate). Beside them, the receiver-stream forwards ``fused_v1`` and
``fused_v2`` (rows 2 and 3) at the 524k graph's two layer shapes.

``--ablate`` also builds altered copies of the body that ``ROOT``'s banded
kernels include and times each at the 524k H 8 F 8 shape (device time
only: most alter the result). Of the block-per-chunk body
(``csrc/fused_v1.cuh``, ``fused_v2.cuh``), which the banded kernels of a
checkout from before the tile-owner body include:

* ``store``: the drain adds the accumulators into ``out`` and ``den`` with
  plain stores instead of global atomics;
* ``noshared``: every add into the shared accumulators is a plain add
  instead of a shared-memory atomic;
* ``nozero``: no memset of ``out`` and ``den``;
* ``all``: the three together.

Of the tile-owner body (``csrc/tile_fused.cuh``): ``nokeep`` (no keep
factor loads: every factor 1), ``batch2`` and ``batch8`` (2 or 8 slots in
flight per unit instead of 4; the same result) and ``threads128`` (blocks
of at most 128 threads instead of 256; the same result). Device times come
from ``chip_smoke._time_ms`` (calls captured in a CUDA graph and replayed
between CUDA events). The results go to ``OUT/banded_ab_NAME.json``
(``--out``, by default the current directory) and, one line per number, to
standard output.
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

KERNELS = ("fused_v1_banded", "fused_v2_banded")
# per body (the header both banded kernels include): text -> its ablated
# form, each found the stated number of times over the body's headers
_ABLATIONS = {
    "fused_v1.cuh": {
        "store": [
            (r"atomicAdd\(&out\[(\(row0 \+ r\) \* HF \+ h0 \* F \+ "
             r"\(i - r \* cols\))\], acc\[i\]\);", r"out[\1] = acc[i];", 2),
            (r"atomicAdd\(&den\[(\(row0 \+ r\) \* H \+ h0 \+ "
             r"\(i - r \* hb\))\], dacc\[i\]\);", r"den[\1] = dacc[i];", 2)],
        "noshared": [
            (r"atomicAdd\(&acc\[cur \* cols \+ col\], sum\);",
             "acc[cur * cols + col] += sum;", 4),
            (r"atomicAdd\(&dacc\[cur \* hb \+ hl\], dsum\);",
             "dacc[cur * hb + hl] += dsum;", 2),
            (r"if \(cur >= 0 && lane == 0\) atomicAdd\(&dacc\[cur \* hb \+ "
             r"cur_hl\], dsum\);",
             "if (cur >= 0 && lane == 0) dacc[cur * hb + cur_hl] += dsum;",
             2)],
        "nozero": [
            (r"cudaError_t e = cudaMemsetAsync\(out, 0, sizeof\(float\) \* "
             r"rows \* H \* F, st\);\s*if \(e == cudaSuccess\)\s*"
             r"e = cudaMemsetAsync\(den, 0, sizeof\(float\) \* rows \* H, "
             r"st\);", "cudaError_t e = cudaSuccess; (void)rows;", 2)],
    },
    "tile_fused.cuh": {
        "nokeep": [(r"\? __ldg\(p\.keepq \+ static_cast<long long>\(o\[u\]\) "
                    r"\* H \+ ln\.h\)", "? 1.f", 1)],
        "batch2": [(r"constexpr int TF_BATCH = 4;",
                    "constexpr int TF_BATCH = 2;", 1)],
        "batch8": [(r"constexpr int TF_BATCH = 4;",
                    "constexpr int TF_BATCH = 8;", 1)],
        "threads128": [(r"constexpr int TF_THREADS = 256;",
                        "constexpr int TF_THREADS = 128;", 1)],
    },
}
_ABLATIONS["fused_v1.cuh"]["all"] = [
    sub for v in ("store", "noshared", "nozero")
    for sub in _ABLATIONS["fused_v1.cuh"][v]]


def _body(root):
    """The header that ``root``'s banded kernels include (the tile-owner
    body, or the block-per-chunk one)."""
    csrc = os.path.join(root, "pygat_tpu_torch", "csrc")
    return ("tile_fused.cuh"
            if os.path.exists(os.path.join(csrc, "tile_fused.cuh"))
            else "fused_v1.cuh")


def _ablated_libs(root, build):
    """Build fused_v1_banded.cu and fused_v2_banded.cu of ``root`` against
    each ablated copy of their body, all nvcc processes at once; returns
    {variant: {kernel: ctypes function}}."""
    csrc = os.path.join(root, "pygat_tpu_torch", "csrc")
    body = _body(root)
    headers = ([body] if body == "tile_fused.cuh"
               else ["fused_v1.cuh", "fused_v2.cuh"])
    out_dir = os.path.join(root, "pygat_tpu_torch", "_build", "ablate_fused")
    procs = []
    for variant, subs in _ABLATIONS[body].items():
        vdir = os.path.join(out_dir, variant)
        shutil.rmtree(vdir, ignore_errors=True)
        shutil.copytree(csrc, vdir)
        texts = {}
        for name in headers:
            with open(os.path.join(csrc, name)) as f:
                texts[name] = f.read()
        for pattern, repl, want in subs:
            hits = 0
            for name, text in texts.items():
                texts[name], n = re.subn(pattern, repl, text)
                hits += n
            if hits != want:
                raise RuntimeError(f"{variant}: {pattern!r} matched {hits} "
                                   f"times, not {want}")
        for name, text in texts.items():
            with open(os.path.join(vdir, name), "w") as f:
                f.write(text)
        for kernel in KERNELS:
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


def _c_args(kernel, args, tile_owner, torch):
    """(C arguments up to the stream, outputs) of a wrapper call's
    arguments for the banded entry points: the tile-owner ones or the
    block-per-chunk ones."""
    tables, keepq, plan, alpha = args[:4], args[4], args[5], args[6]
    a = tables[3]
    h, f = a.shape
    n_pad = plan.n_pad
    out = torch.empty(n_pad, h * f, device="cuda")
    den = torch.empty(n_pad, h, device="cuda")
    if tile_owner:
        walk = plan.spmm_walk
        n_split = plan.split_at.numel()
        part_out = torch.empty(max(n_split, 1), 128, h * f, device="cuda")
        part_den = torch.empty(max(n_split, 1), 128, h, device="cuda")
        c = (*tables, keepq, walk.rows, walk.order, walk.row_ptr,
             plan.tile_ptr, plan.split_at, n_pad // 128, n_split,
             plan.max_run, h, f, alpha, out, den, part_out, part_den)
    else:
        c = (*tables, keepq, plan.band, plan.s_loc, plan.r_local,
             plan.r_chunk, plan.num_chunks, n_pad // 128, plan.w, h, f, alpha,
             out, den)
    c = [x.data_ptr() if isinstance(x, torch.Tensor) else x for x in c]
    return c, (out, den)


def _call(fn, c_args, kernel):
    """Launch a kernel library's entry point on the current stream (inside a
    CUDA-graph capture, the capturing one)."""
    import torch

    rc = fn(*c_args, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"{kernel}: CUDA error {rc} at launch")


def _bound_ms(cs, kernel, plan, h, f):
    """chip_smoke's bound of a fused banded forward: each node table once,
    the per-node head terms, a, a live slot's keep factors, the plan's
    index words (s_loc, r_local; band, r_chunk), out and den once."""
    n, e, c = plan.n_pad, plan.num_slots, plan.num_chunks
    n_live = int((plan.r_local < 128).sum())
    tables, narrow = (1, 2) if kernel == "fused_v1_banded" else (2, 1)
    n_bytes = 4 * (tables * n * h * f + narrow * n * h + h * f + n_live * h
                   + 2 * e + 2 * c + n * (h * f + h))
    n_flops = n_live * ((4 if tables == 1 else 6) * h * f + 6 * h)
    return cs._bound(n_bytes, n_flops)[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", help="checkout whose kernels are timed")
    ap.add_argument("--tag", required=True, help="name of this run")
    ap.add_argument("--out", default=".", help="directory of the JSON file")
    ap.add_argument("--ablate", action="store_true",
                    help="also time ablated copies of the banded body")
    a = ap.parse_args()
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("banded_ab: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from pygat_tpu_torch.data.citation import load_citation
    from pygat_tpu_torch.ops import banded as bd
    from pygat_tpu_torch.ops import build
    from pygat_tpu_torch.ops import fused_stream as fs
    from pygat_tpu_torch.tools.profile_epoch import large_dataset

    if not build.PKG_DIR.startswith(root):
        raise RuntimeError(f"imported {build.PKG_DIR}, not {root}'s package")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs._card_line()
    print(f"banded_ab {a.tag}: {root}; card {card!r}", flush=True)
    t0 = time.perf_counter()
    print(f"  built in {build.build_all():.1f} s", flush=True)
    tile_owner = _body(root) == "tile_fused.cuh"
    res = {"tag": a.tag, "root": root, "card": card, "body": _body(root),
           "cases": []}
    big = dict(calls=cs.BIG_CALLS, replays=cs.BIG_REPLAYS)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(72)
    make = {"fused_v1_banded": cs._fused_inputs,
            "fused_v2_banded": cs._fused_v2_inputs}

    large = large_dataset()
    cora = load_citation("cora", device="cuda")
    hub = cs._hub_graph()
    plans = {"large": bd.maybe_plan_large(large.graph),
             "cora": bd.build_band_plan(cora.graph, w=4),
             "hub": bd.build_band_plan(hub, w=4)}
    graphs = {"large": large.graph, "cora": cora.graph, "hub": hub}
    shapes = {"large": ((8, 8), (1, 4), (1, 64), (1, 256)),
              "cora": ((8, 8), (1, 7)), "hub": ((8, 8),)}
    for label, plan in plans.items():
        for kernel in KERNELS:
            wrapper = getattr(bd, kernel)
            plain = getattr(bd, kernel + "_plain")
            for h, f in shapes[label]:
                args = make[kernel](graphs[label], h, f, gen, plan)
                got = wrapper(*args)
                row = dict(dataset=label, kernel=kernel, H=h, F=f)
                if f <= 64:
                    want = plain(*args)
                    torch.cuda.synchronize()
                    errs = [cs._max_err(g_, w_) for g_, w_ in zip(got, want)]
                    row["max_abs_err"] = max(e for e, _ in errs)
                    if any(e > allowed for e, allowed in errs):
                        raise AssertionError(f"{kernel} {label} H {h} F {f} "
                                             f"disagrees with its plain "
                                             f"version: {errs}")
                    del want
                again = wrapper(*args)
                row["bitwise_repeat"] = all(
                    torch.equal(x, y) for x, y in zip(got, again))
                del got, again
                kw = big if label == "large" else {}
                row["ms"] = cs._time_ms(lambda: wrapper(*args), **kw)
                row["bound_ms"] = _bound_ms(cs, kernel, plan, h, f)
                if a.ablate and label == "large" and (h, f) == (8, 8):
                    row["args"] = args
                print(f"  {kernel} {label} H {h} F {f}: {row['ms']:.4f} ms, "
                      f"bound {row['bound_ms']:.5f} ms, error "
                      f"{row.get('max_abs_err', float('nan')):.3e}, bitwise "
                      f"repeat {row['bitwise_repeat']}", flush=True)
                res["cases"].append(row)
                del args
                torch.cuda.empty_cache()
    fwd = {k: sum(c["ms"] for c in res["cases"] if c["kernel"] == k
                  and c["dataset"] == "large" and (c["H"], c["F"]) in
                  ((8, 8), (1, 4))) for k in KERNELS}
    res["large_forward_ms"] = fwd
    print(f"  524k forward (both launches): " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in fwd.items()), flush=True)

    # rows 2 and 3 over the receiver stream at the 524k layer shapes
    res["stream"] = []
    g = large.graph
    for kernel, fn, mk in (("fused_v1", fs.fused_v1, cs._fused_inputs),
                           ("fused_v2", fs.fused_v2, cs._fused_v2_inputs)):
        for h, f in ((8, 8), (1, 4)):
            args = mk(g, h, f, gen)
            ms = cs._time_ms(lambda: fn(*args), **big)
            n, e = g.num_nodes_padded, g.num_edges_padded
            n_live = int((g.r_local < 128).sum())
            tables, narrow = (1, 2) if kernel == "fused_v1" else (2, 1)
            n_bytes = 4 * (tables * n * h * f + narrow * n * h + h * f
                           + n_live * h + 2 * e + g.r_chunk.numel()
                           + n * (h * f + h))
            bound = cs._bound(n_bytes, n_live * (
                (4 if tables == 1 else 6) * h * f + 6 * h))[0]
            res["stream"].append(dict(kernel=kernel, H=h, F=f, ms=ms,
                                      bound_ms=bound))
            print(f"  {kernel} large (receiver stream) H {h} F {f}: "
                  f"{ms:.4f} ms, bound {bound:.5f} ms", flush=True)
            del args
            torch.cuda.empty_cache()

    if a.ablate:
        libs = _ablated_libs(root, build)
        res["ablate"] = []
        for case in res["cases"]:
            args = case.pop("args", None)
            if args is None:
                continue
            kernel = case["kernel"]
            c_args, _ = _c_args(kernel, args, tile_owner, torch)
            row = {"kernel": kernel, "H": case["H"], "F": case["F"]}
            for variant, fn in [("base", build.kernel(kernel))] + [
                    (v, fns[kernel]) for v, fns in libs.items()]:
                row[f"{variant}_ms"] = cs._time_ms(
                    lambda: _call(fn, c_args, kernel), **big)
            print(f"  {_body(root)} {kernel} large H {case['H']} F "
                  f"{case['F']}: " + ", ".join(
                      f"{k} {v:.4f}" for k, v in row.items()
                      if k.endswith("_ms")), flush=True)
            res["ablate"].append(row)
            del args, c_args
            torch.cuda.empty_cache()
    for case in res["cases"]:
        case.pop("args", None)

    print(f"  {time.perf_counter() - t0:.1f} s", flush=True)
    os.makedirs(a.out, exist_ok=True)
    with open(os.path.join(a.out, f"banded_ab_{a.tag}.json"), "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
