"""The port's offline tools on the CPU, against the JAX package where it has
the same function: dataset preparation (``data/prepare.py``: the artifact
check, the cites export, the DGL export with DGL mocked and without it),
the gated PPI download (mocked), the debug helpers (``utils/debug.py``),
the profiling hooks (``utils/profiling.py``) and the entry file
(``graft_entry.py``)."""

from __future__ import annotations

import hashlib
import io
import json
import os
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from pygat_tpu.data import prepare as jprepare
from tests.test_prepare import _FakeDGL, _fake_ppi_zip
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from pygat_tpu_torch import graft_entry
from pygat_tpu_torch.data import ppi as tppi
from pygat_tpu_torch.data import prepare as tprepare
from pygat_tpu_torch.models.convert import params_from_jax
from pygat_tpu_torch.models.gat import GATConfig, apply_gat, init_gat
from pygat_tpu_torch.train.state import init_state, make_optimizer
from pygat_tpu_torch.utils import debug, profiling
from pygat_tpu_torch.utils.platform import make_generator


@pytest.fixture
def root(tmp_path, monkeypatch):
    """An empty data root as the working directory, no $PYGAT_DATA."""
    monkeypatch.delenv("PYGAT_DATA", raising=False)
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_prepare_check_reports_each_artifact(root):
    (root / "data" / "cora").mkdir(parents=True)
    (root / "data" / "cora" / "cora.cites").write_text("1 2\n")
    report = tprepare.check(str(root))
    assert tprepare.ARTIFACTS == jprepare.ARTIFACTS
    assert {ds: set(paths) for ds, paths in report.items()} == {
        ds: set(paths) for ds, paths in jprepare.ARTIFACTS.items()}
    found = {p: v for ds in report.values() for p, v in ds.items()
             if v != "MISSING"}
    assert found == {"data/cora/cora.cites":
                     str(root / "data" / "cora" / "cora.cites")}
    out = io.StringIO()
    with redirect_stdout(out):
        assert tprepare.main(["--check", "--data-root", str(root)]) == 0
    assert f"{sum(map(len, report.values())) - 1} artifacts missing" in \
        out.getvalue()


def test_export_cites_adjacency_matches_jax(root):
    rng = np.random.default_rng(4)
    ids = np.array(["p%d" % i for i in rng.permutation(60)] + ["x1", "77"])
    pairs = rng.integers(0, len(ids), (150, 2))
    cites = root / "citeseer.cites"
    cites.write_text("".join(f"{ids[a]}\t{ids[b]}\n" for a, b in pairs))
    got = tprepare.export_cites_adjacency(str(cites), str(root / "t.npz"))
    want = jprepare.export_cites_adjacency(str(cites), str(root / "j.npz"))
    assert {k: v for k, v in got.items() if k != "out"} == \
        {k: v for k, v in want.items() if k != "out"}
    a, b = sp.load_npz(root / "t.npz"), sp.load_npz(root / "j.npz")
    assert a.shape == b.shape and a.format == b.format
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_export_dgl_mocked_and_without_dgl(root):
    out = root / "citeseer_dgl"
    info = tprepare.export_dgl("citeseer", str(out), _dgl=_FakeDGL(),
                               _torch=torch)
    assert info["nodes"] == 40 and info["edges"] == 40
    for f in ("features.pt", "labels.pt", "idx_train.pt", "idx_val.pt",
              "idx_test.pt", "adj_sparse.npz"):
        assert (out / f).exists()
    assert tuple(torch.load(out / "features.pt").shape) == (40, 16)
    assert torch.equal(torch.load(out / "idx_train.pt"), torch.arange(20))
    adj = sp.load_npz(out / "adj_sparse.npz")
    assert adj.shape == (40, 40) and adj.nnz == 40
    with pytest.raises(ValueError, match="no DGL export"):
        tprepare.export_dgl("ppi", str(root / "y"), _dgl=_FakeDGL())
    with pytest.raises(RuntimeError, match="dgl"):
        tprepare.export_dgl("citeseer", str(root / "x"))


def test_prepare_main_writes_the_manifest(root):
    out = io.StringIO()
    with redirect_stdout(out):
        assert tprepare.main(["--dataset", "cora", "--out",
                              str(root / "prep")]) == 0
    manifest = json.loads((root / "prep" / "MANIFEST.json").read_text())
    assert manifest["dataset"] == "cora"
    assert manifest["synthetic"] == ["topology", "features", "labels"]


def _fetcher(payload, calls):
    def fetch(url, path):
        calls.append(url)
        with open(path, "wb") as f:
            f.write(payload)

    return fetch


def test_ppi_download_gated_off(root, monkeypatch):
    """Off by default: nothing fetched, and load_ppi asks it where no root
    has the files, then builds the stand-ins as before."""
    monkeypatch.delenv("PYGAT_ALLOW_DOWNLOAD", raising=False)

    def fetch(url, path):  # must never run
        raise AssertionError("network touched while downloads are off")

    assert not tppi.ensure_ppi_download(str(root), _fetch=fetch)
    asked = []
    monkeypatch.setattr(tppi, "ensure_ppi_download",
                        lambda dest, **kw: asked.append(dest) or False)
    monkeypatch.setattr(tppi, "_load_split",
                        lambda split, roots: ([], [f"{split}_graph"]))
    data = tppi.load_ppi(str(root))
    assert asked == [str(root)]
    assert data.synthetic_parts == ("train_graph", "valid_graph",
                                    "test_graph")


def test_ppi_download_fetched_and_sha_pinned(root, monkeypatch):
    monkeypatch.setenv("PYGAT_ALLOW_DOWNLOAD", "1")
    payload, calls = _fake_ppi_zip(), []
    bad = root / "bad"
    assert not tppi.ensure_ppi_download(str(bad), sha256="0" * 64,
                                        _fetch=_fetcher(payload, calls))
    assert not (bad / "data" / "ppi" / "train_feats.npy").exists()
    assert not (bad / "data" / "ppi" / "ppi.zip").exists()
    good = hashlib.sha256(payload).hexdigest()
    assert tppi.ensure_ppi_download(str(root), sha256=good,
                                    _fetch=_fetcher(payload, calls))
    d = root / "data" / "ppi"
    for split in ("train", "valid", "test"):
        assert (d / f"{split}_feats.npy").exists()
        assert (d / f"{split}_graph.json").exists()
    assert not (d / "ppi.zip").exists()
    assert calls == [tppi.PPI_URL] * 2 == ["https://data.dgl.ai/dataset/ppi.zip"] * 2
    # present: no second fetch, and the loader reads the files
    assert tppi.ensure_ppi_download(str(root),
                                    _fetch=_fetcher(payload, calls))
    assert len(calls) == 2
    data = tppi.load_ppi(str(root))
    assert [len(s) for s in data[:3]] == [1, 1, 1]
    assert data.synthetic_parts == ()


@pytest.fixture(scope="module")
def small():
    """A 300-node GAT_sparse model and its data on the CPU."""
    from pygat_tpu_torch.graph import build_graph

    rng = np.random.default_rng(2)
    n = 300
    s = np.concatenate([rng.integers(0, n, n * 4), np.arange(n)])
    r = np.concatenate([rng.integers(0, n, n * 4), np.arange(n)])
    g = build_graph(s, r, None, n, device="cpu")
    x = torch.from_numpy(rng.standard_normal(
        (g.num_nodes_padded, 16)).astype(np.float32))
    cfg = GATConfig(nlayers=2, nheads=(2, 1), nfeats=(16, 8, 3), dropout=0.0,
                    alpha=0.2, layer_type="GAT_sparse")
    return cfg, g, x


def test_checkify_step_names_what_is_not_finite(small):
    from pygat_tpu_torch.train.loop import make_transductive_steps

    cfg, g, x = small
    labels = torch.zeros(g.num_nodes_padded, dtype=torch.int32)
    idx = torch.arange(100, dtype=torch.int32)
    params = init_gat(cfg, make_generator("cpu", 1), device="cpu")
    state = init_state(params, make_optimizer(params, 0.01, 0.0),
                       make_generator("cpu", 2))
    step = debug.checkify_step(make_transductive_steps(cfg)[0])
    state, loss, _, _ = step(state, x, g, labels, idx)
    assert np.isfinite(float(loss))
    with pytest.raises(FloatingPointError, match="output 0"):
        step(state, x * float("nan"), g, labels, idx)
    # a fresh state: a gradient, then a parameter, not finite
    params = init_gat(cfg, make_generator("cpu", 1), device="cpu")
    state = init_state(params, make_optimizer(params, 0.01, 0.0),
                       make_generator("cpu", 2))
    noop = debug.checkify_step(lambda st: (st, torch.ones(())))
    noop(state)
    params[1].W.grad = torch.full_like(params[1].W, float("inf"))
    with pytest.raises(FloatingPointError,
                       match="the gradient of layer 1 W"):
        noop(state)
    params[1].W.grad = None
    with torch.no_grad():
        params[1].a[0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="parameter layer 1 a"):
        noop(state)


def test_debug_nans_op_histogram_and_the_aten_graph(small, tmp_path):
    cfg, g, x = small
    params = init_gat(cfg, make_generator("cpu", 1), device="cpu")

    @torch.no_grad()
    def fwd(x):
        return apply_gat(params, cfg, x, g, None, train=False)

    hist = debug.op_histogram(fwd, x)
    assert hist["aten.index_add_"] >= 2 and hist["aten.bmm"] >= 1
    assert all(n > 0 for n in hist.values())
    assert not [k for k in hist if k.startswith("kernel:")]  # plain on CPU
    code = debug.dump_aten_graph(fwd, x, path=str(tmp_path / "g.txt"))
    assert "index_add" in code and (tmp_path / "g.txt").read_text() == code
    with pytest.raises(NotImplementedError, match="dump_aten_graph"):
        debug.dump_hlo(fwd, x)
    with debug.debug_nans():
        fwd(x)  # a finite forward passes, -inf masks included
        with pytest.raises(FloatingPointError, match="NaN"):
            torch.zeros(2) / torch.zeros(2)
    assert torch.isnan(torch.zeros(1) / torch.zeros(1)).all()  # off again


def test_profiling_trace_top_ops_and_step_timer(small, tmp_path):
    cfg, g, x = small
    a, b = torch.randn(64, 32), torch.randn(32, 16)
    path = str(tmp_path / "trace.json")
    with profiling.trace(path, cuda=False) as prof:
        with profiling.annotate("matmul"):
            (a @ b).sum()
    rows = profiling.top_ops(prof, 50, device=False)
    assert "aten::mm" in [r[0] for r in rows]
    shaped = profiling.top_ops(prof, 50, shapes=True, device=False)
    assert ("aten::mm", "[[64, 32], [32, 16]]") in [r[:2] for r in shaped]
    assert os.path.getsize(path) > 0
    assert profiling.top_ops(prof, 5) == []  # no device time on the CPU
    top = profiling.profile_top_ops(lambda: a @ b, k=3)
    assert top and top[0][0] == "aten::mm"
    timer = profiling.StepTimer()
    assert timer.summary() == {"steps": 0}
    step = timer.timed(lambda y: y * 2)
    assert torch.equal(step(torch.ones(2)), torch.full((2,), 2.0))
    step(torch.ones(2))
    s = timer.summary()
    assert s["steps"] == 2 and s["min_ms"] <= s["p50_ms"] <= s["max_ms"]


def test_graft_entry_matches_jax():
    """The port's entry() on the CPU: the same graph and features as the
    JAX entry() and, on the JAX entry's parameters, the same forward
    within 1e-5 of its largest output; dryrun_multichip without a process
    group raises, as make_mesh does."""
    import __graft_entry__ as jentry

    jfn, (jparams, jx, jgraph, jrng) = jentry.entry()
    fn, (params, x, graph) = graft_entry.entry(device="cpu")
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    for f in jgraph._fields:
        a, b = getattr(jgraph, f), getattr(graph, f)
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=f)
    assert [tuple(t.shape) for layer in params for t in layer
            if t is not None] == [tuple(t.shape) for layer in jparams
                                  for t in layer if t is not None]
    want = np.asarray(jax.jit(jfn)(jparams, jx, jgraph, jrng))
    with torch.no_grad():
        got = fn(params_from_jax([tuple(None if t is None else np.asarray(t)
                                        for t in layer) for layer in jparams],
                                 device="cpu"), x, graph)
    assert got.shape == want.shape == (2816, 7)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))
    with pytest.raises(RuntimeError, match="process group of 4 ranks"):
        graft_entry.dryrun_multichip(4)
