"""Offline dataset preparation CLI (port of ``pygat_tpu/data/prepare.py``):
the equivalent of the reference's get_cora/get_citeseer/get_pubmed
notebooks (reference get_*.ipynb), which exported DGL datasets into
``{name}_dgl/`` tensors consumed by ``utils.load_data``.

The command works without network access and without DGL:

* verifies which artifacts are present or missing for each dataset, in
  the loaders' search roots (``--data-root``, ``$PYGAT_DATA``, the working
  directory);
* re-exports whatever can be derived from raw text (e.g. citeseer.cites ->
  adjacency npz, with the reference notebook's dangling-edge cleanup:
  get_citeseer.ipynb cell 9 drops edges whose endpoints are missing);
* writes deterministic synthetic stand-ins for anything else, so training
  runs end-to-end; every synthetic file is tagged in a MANIFEST.json.

Usage:
    python -m pygat_tpu_torch.data.prepare --dataset citeseer --out ./citeseer_dgl
    python -m pygat_tpu_torch.data.prepare --check          # report artifact status

Loading a dataset to find its stand-ins runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import scipy.sparse as sp

from pygat_tpu_torch.data.citation import _find, _search_roots

ARTIFACTS = {
    "cora": ["data/cora/cora.content", "data/cora/cora.cites"],
    "citeseer": [
        "citeseer_dgl/adj_sparse.npz", "citeseer_dgl/features.pt",
        "citeseer_dgl/labels.pt", "citeseer_dgl/idx_train.pt",
        "citeseer_dgl/idx_val.pt", "citeseer_dgl/idx_test.pt",
        "data/cora/citeseer.cites",
    ],
    "pubmed": [
        "pubmed_dgl/adj_sparse.npz", "pubmed_dgl/features.pt",
        "pubmed_dgl/labels.pt", "pubmed_dgl/idx_train.pt",
        "pubmed_dgl/idx_val.pt", "pubmed_dgl/idx_test.pt",
    ],
    "ppi": [
        f"data/ppi/{s}_{k}" for s in ("train", "valid", "test")
        for k in ("feats.npy", "labels.npy", "graph.json", "graph_id.npy")
    ],
}


def check(data_root: str | None = None) -> dict:
    roots = _search_roots(data_root)
    report = {}
    for ds, paths in ARTIFACTS.items():
        report[ds] = {p: (_find(p, roots) or "MISSING") for p in paths}
    return report


def export_cites_adjacency(cites_path: str, out_npz: str) -> dict:
    """Raw citation edge list -> node-id map + COO adjacency npz.

    Mirrors the reference notebooks' export (string paper ids remapped to
    dense ints, reference utils.py:25-28; dangling citeseer endpoints kept —
    every id appearing in the .cites file becomes a node)."""
    edges_raw = np.genfromtxt(cites_path, dtype=str)
    ids = np.unique(edges_raw)
    idx = {j: i for i, j in enumerate(ids)}
    e0 = np.array([idx[a] for a in edges_raw[:, 0]], np.int64)
    e1 = np.array([idx[b] for b in edges_raw[:, 1]], np.int64)
    n = len(ids)
    adj = sp.coo_matrix((np.ones(len(e0), np.float32), (e0, e1)), shape=(n, n))
    sp.save_npz(out_npz, adj.tocsr())
    return {"nodes": n, "edges": int(len(e0)), "out": out_npz}


def export_dgl(dataset: str, out_dir: str, *, _dgl=None, _torch=None) -> dict:
    """Regenerate the ``{name}_dgl/`` tensors from DGL — the reference's
    get_pubmed.ipynb / get_citeseer.ipynb cells 1-2 (AddSelfLoop transform,
    feat/label tensors, train/val/test index vectors from the boolean
    masks, COO adjacency of ones saved as npz).

    Requires ``dgl`` (and network access on its first use); without it
    the import is guarded and the error says what to install. ``_dgl``/``_torch`` are injectable
    for tests. Output filenames match what ``data/citation.py`` (and the
    reference ``utils.load_data``) consume.
    """
    if _dgl is None:
        try:
            import dgl as _dgl  # noqa: F811
        except ImportError as exc:
            raise RuntimeError(
                "export_dgl needs the 'dgl' package (pip install dgl); "
                "without it the loaders build synthetic stand-ins") from exc
    if _torch is None:
        import torch as _torch  # noqa: F811

    datasets = {
        "citeseer": "CiteseerGraphDataset",
        "pubmed": "PubmedGraphDataset",
        "cora": "CoraGraphDataset",
    }
    if dataset not in datasets:
        raise ValueError(f"no DGL export for dataset {dataset!r}")
    data = getattr(_dgl.data, datasets[dataset])(
        transform=_dgl.AddSelfLoop())
    g = data[0]
    features = g.ndata["feat"]
    labels = g.ndata["label"]
    idx = {
        "idx_train": _torch.nonzero(g.ndata["train_mask"],
                                    as_tuple=False).squeeze(),
        "idx_val": _torch.nonzero(g.ndata["val_mask"],
                                  as_tuple=False).squeeze(),
        "idx_test": _torch.nonzero(g.ndata["test_mask"],
                                   as_tuple=False).squeeze(),
    }
    src, dst = g.edges()
    num_nodes = int(g.num_nodes())
    adj = sp.coo_matrix(
        (np.ones(int(src.shape[0]), np.float32),
         (np.asarray(src), np.asarray(dst))),
        shape=(num_nodes, num_nodes), dtype=np.float32)

    os.makedirs(out_dir, exist_ok=True)
    _torch.save(features, os.path.join(out_dir, "features.pt"))
    _torch.save(labels, os.path.join(out_dir, "labels.pt"))
    for name, t in idx.items():
        _torch.save(t, os.path.join(out_dir, f"{name}.pt"))
    sp.save_npz(os.path.join(out_dir, "adj_sparse.npz"), adj.tocoo())
    return {"dataset": dataset, "nodes": num_nodes,
            "edges": int(src.shape[0]), "out": out_dir}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="pygat_tpu_torch offline dataset prep")
    p.add_argument("--check", action="store_true", help="report artifact status")
    p.add_argument("--dataset", choices=["cora", "citeseer", "pubmed", "ppi"])
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--data-root", type=str, default=None)
    p.add_argument("--export-dgl", action="store_true",
                   help="regenerate {name}_dgl tensors via DGL "
                        "(needs dgl installed; reference get_*.ipynb)")
    p.add_argument("--download-ppi", action="store_true",
                   help="fetch data.dgl.ai/dataset/ppi.zip into --out "
                        "(needs PYGAT_ALLOW_DOWNLOAD=1)")
    args = p.parse_args(argv)

    if args.export_dgl:
        if not args.dataset or args.dataset == "ppi":
            p.error("--export-dgl needs --dataset cora|citeseer|pubmed")
        out = args.out or f"{args.dataset}_dgl"
        info = export_dgl(args.dataset, out)
        print(json.dumps(info))
        return 0
    if args.download_ppi:
        from pygat_tpu_torch.data.ppi import ensure_ppi_download

        dest = args.out or args.data_root or os.getcwd()
        ok = ensure_ppi_download(dest)
        print(json.dumps({"downloaded": ok, "dest": dest}))
        return 0 if ok else 1

    if args.check or not args.dataset:
        report = check(args.data_root)
        print(json.dumps(report, indent=2))
        missing = sum(v == "MISSING" for ds in report.values() for v in ds.values())
        print(f"\n{missing} artifacts missing (loaders substitute deterministic "
              "synthetic stand-ins; see pygat_tpu_torch/data/synthetic.py)")
        return 0

    out = args.out or f"{args.dataset}_prepared"
    os.makedirs(out, exist_ok=True)
    manifest = {"dataset": args.dataset, "generated": [], "synthetic": []}
    roots = _search_roots(args.data_root)

    if args.dataset == "citeseer":
        cites = _find("data/cora/citeseer.cites", roots)
        if cites:
            info = export_cites_adjacency(cites, os.path.join(out, "adj_from_cites.npz"))
            manifest["generated"].append(info)

    # force the loaders once: they materialize synthetic stand-ins and
    # report what was substituted
    if args.dataset == "ppi":
        from pygat_tpu_torch.data.ppi import load_ppi

        data = load_ppi(data_root=args.data_root)
        manifest["synthetic"] = list(data.synthetic_parts)
    else:
        from pygat_tpu_torch.data.citation import load_citation

        ds = load_citation(args.dataset, data_root=args.data_root,
                           device="cpu")
        manifest["synthetic"] = list(ds.synthetic_parts)

    path = os.path.join(out, "MANIFEST.json")
    with open(path, "w") as f:
        json.dump(manifest, f, indent=2)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
