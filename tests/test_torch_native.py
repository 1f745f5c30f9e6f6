"""The port's host graph library (``pygat_tpu_torch/native.py`` over its own
``csrc/graphops.cpp``) and the reordered citation path on the CPU: the
library against the JAX package's (its library and its numpy path) and the
port's plain versions on seeded graphs with multi-edges, self-loops,
isolated nodes and several components; a failed build raises;
``load_citation(reorder=True)`` against the JAX loader array for array; and
both sparse models on the reordered Cora against the JAX ``apply_gat``
(forward and gradients) and against the unreordered graph permuted."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from pygat_tpu import native as jnative
from pygat_tpu.data import citation as jcitation
from pygat_tpu.models import gat as jgat
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from pygat_tpu_torch import native as tnative
from pygat_tpu_torch.data import citation as tcitation
from pygat_tpu_torch.models import gat as tgat
from pygat_tpu_torch.models.convert import params_from_jax

SEEDS = (0, 1, 2)


def _graph(seed):
    """(senders, receivers, n): two components (nodes 0-199 and 200-349,
    each edge in both directions), duplicated edges, self-loops on some
    nodes, and nodes 350-399 isolated."""
    rng = np.random.default_rng(seed)
    parts = []
    for lo, hi, e in ((0, 200, 900), (200, 350, 500)):
        a = rng.integers(lo, hi, e)
        b = rng.integers(lo, hi, e)
        parts.append((np.concatenate([a, b]), np.concatenate([b, a])))
    s = np.concatenate([p[0] for p in parts])
    r = np.concatenate([p[1] for p in parts])
    dup = rng.integers(0, len(s), 200)
    loops = rng.integers(0, 350, 60)
    s = np.concatenate([s, s[dup], loops])
    r = np.concatenate([r, r[dup], loops])
    return s, r, 400


def _jax_numpy(monkeypatch):
    """The JAX loader forced onto its numpy path."""
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", True)


@pytest.mark.parametrize("seed", SEEDS)
def test_build_csr_matches_jax_and_plain(seed, monkeypatch):
    s, r, n = _graph(seed)
    got = tnative.build_csr(s, r, n)
    assert [a.dtype for a in got] == [np.int32] * 3
    for want in (tnative.build_csr(s, r, n, plain=True),
                 jnative.build_csr(s, r, n)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    _jax_numpy(monkeypatch)
    for a, b in zip(got, jnative.build_csr(s, r, n)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", SEEDS)
def test_rcm_order_matches_jax_and_plain(seed, monkeypatch):
    s, r, n = _graph(seed)
    rowptr, col, _ = tnative.build_csr(s, r, n)
    got = tnative.rcm_order(rowptr, col, n)
    assert sorted(got.tolist()) == list(range(n))
    np.testing.assert_array_equal(
        got, tnative.rcm_order(rowptr, col, n, plain=True))
    np.testing.assert_array_equal(got, jnative.rcm_order(rowptr, col, n))
    _jax_numpy(monkeypatch)
    np.testing.assert_array_equal(got, jnative.rcm_order(rowptr, col, n))


@pytest.mark.parametrize("seed", SEEDS)
def test_sym_norm_weights_and_apply_reorder_match_jax(seed, monkeypatch):
    s, r, n = _graph(seed)
    w = tnative.sym_norm_weights(s, r, n)
    assert w.dtype == np.float32
    np.testing.assert_array_equal(
        w, tnative.sym_norm_weights(s, r, n, plain=True))
    np.testing.assert_array_equal(w, jnative.sym_norm_weights(s, r, n))
    order = tnative.rcm_order(*tnative.build_csr(s, r, n)[:2], n)
    got = tnative.apply_reorder(order, s, r)
    _jax_numpy(monkeypatch)
    np.testing.assert_array_equal(w, jnative.sym_norm_weights(s, r, n))
    for a, b in zip(got, jnative.apply_reorder(order, s, r)):
        np.testing.assert_array_equal(a, b)
    s2, r2, inverse = got
    np.testing.assert_array_equal(order[s2], s)
    np.testing.assert_array_equal(order[r2], r)
    np.testing.assert_array_equal(inverse[order], np.arange(n))


def test_rcm_narrows_a_scrambled_band():
    """A banded graph under scrambled ids: RCM brings the mean |sender -
    receiver| distance back near the band's."""
    rng = np.random.default_rng(3)
    n = 2048
    src = np.repeat(np.arange(n), 6)
    dst = np.clip(src + rng.integers(-3, 4, len(src)), 0, n - 1)
    scram = rng.permutation(n)
    s = np.concatenate([scram[src], scram[dst]])
    r = np.concatenate([scram[dst], scram[src]])
    order = tnative.rcm_order(*tnative.build_csr(s, r, n)[:2], n)
    s2, r2, _ = tnative.apply_reorder(order, s, r)
    assert np.abs(s2 - r2).mean() < 0.02 * np.abs(s - r).mean()


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """The loader with nothing loaded and an empty build directory."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    return tmp_path


def test_broken_source_raises_with_the_compiler_output(fresh_build,
                                                       monkeypatch):
    bad = fresh_build / "graphops.cpp"
    bad.write_text('extern "C" int graphops_abi_version() { return }\n')
    monkeypatch.setattr(tnative, "SRC", str(bad))
    with pytest.raises(RuntimeError, match="failed") as info:
        tnative.rcm_order(np.zeros(2, np.int32), np.zeros(0, np.int32), 1)
    assert "error" in str(info.value)
    assert not tnative.available()
    assert not list((fresh_build / "build").glob("*.so"))


def test_missing_compiler_raises(fresh_build, monkeypatch):
    monkeypatch.setenv("CXX", str(fresh_build / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        tnative.build_csr(np.zeros(1, np.int32), np.zeros(1, np.int32), 1)
    assert not tnative.available()


def test_library_loads_from_the_port(monkeypatch):
    """The port's own library, built from its own source, ABI 1."""
    assert tnative.available()
    path = tnative.lib_path()
    assert path.startswith(tnative.BUILD_DIR) and path.endswith(".so")
    assert tnative.SRC.endswith("pygat_tpu_torch/csrc/graphops.cpp")
    assert tnative.load().graphops_abi_version() == tnative.ABI_VERSION == 1


@pytest.fixture(scope="module")
def reordered():
    """The JAX and the port's reordered datasets, and the port's
    unreordered Cora."""
    out = {name: (jcitation.load_citation(name, reorder=True),
                  tcitation.load_citation(name, reorder=True, device="cpu"))
           for name in ("cora", "citeseer")}
    out["cora plain"] = tcitation.load_citation("cora", device="cpu")
    return out


@pytest.mark.parametrize("name", ["cora", "citeseer"])
def test_load_citation_reorder_matches_jax(reordered, name):
    dj, dt = reordered[name]
    for f in dj.graph._fields:
        a, b = getattr(dj.graph, f), getattr(dt.graph, f)
        if a is None:
            assert b is None, f
            continue
        b = b.numpy()
        assert np.asarray(a).dtype == b.dtype, f
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=f)
    for f in ("features", "labels", "idx_train", "idx_val", "idx_test"):
        a, b = np.asarray(getattr(dj, f)), getattr(dt, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert dj.synthetic_parts == dt.synthetic_parts
    assert jcitation.dataset_stats(dj) == tcitation.dataset_stats(dt)
    # the walks are built for the reordered graph
    assert dt.graph.stream_walk is not None and dt.graph.sender_walk is not None


def _cfg(layer_type, ds):
    from pygat_tpu_torch.models.presets import PRESETS

    kw = dict(PRESETS["cora"], dropout=0.0)
    kw["nfeats"] = (int(ds.features.shape[1]),) + tuple(kw["nfeats"][1:])
    return (jgat.GATConfig(layer_type=layer_type, **kw),
            tgat.GATConfig(layer_type=layer_type, **kw))


def _numpy_params(jparams):
    return [tuple(None if t is None else np.asarray(t) for t in p)
            for p in jparams]


@pytest.mark.parametrize("layer_type", ["GAT_sparse", "GATv2_sparse"])
def test_models_on_reordered_cora_match_jax_and_permute(reordered,
                                                        layer_type):
    """Forward and gradients (the loss: sum of sin over the real rows) on
    the reordered Cora against the JAX model on the JAX reordered Cora, to
    1e-5 of the largest value; the output equals the unreordered graph's
    permuted, to 1e-5 of the largest output."""
    dj, dt = reordered["cora"]
    cfg_j, cfg_t = _cfg(layer_type, dt)
    jparams = jgat.init_gat(jax.random.PRNGKey(4), cfg_j)
    mask = np.asarray(dj.graph.node_mask)

    def loss(p):
        out = jgat.apply_gat(p, cfg_j, dj.features, dj.graph,
                             jax.random.PRNGKey(1), train=False)
        return jnp.sum(jnp.where(mask[:, None], jnp.sin(out), 0.0)), out

    (_, out_j), grads_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jparams)
    tparams = params_from_jax(_numpy_params(jparams), device="cpu")
    out_t = tgat.apply_gat(tparams, cfg_t, dt.features, dt.graph, None,
                           train=False)
    torch.sin(out_t[dt.graph.node_mask]).sum().backward()
    out_t = out_t.detach()
    scale = float(np.abs(np.asarray(out_j)).max())
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0,
                               atol=1e-5 * scale)
    gj = np.asarray(ravel_pytree(grads_j)[0])
    gt = torch.cat([p.grad.reshape(-1)
                    for p in tgat.parameters(tparams)]).numpy()
    np.testing.assert_allclose(gt, gj, rtol=0,
                               atol=1e-5 * float(np.abs(gj).max()))

    plain = reordered["cora plain"]
    with torch.no_grad():
        out_p = tgat.apply_gat(params_from_jax(_numpy_params(jparams),
                                               device="cpu"),
                               cfg_t, plain.features, plain.graph, None,
                               train=False)
    n = plain.num_nodes
    order = _rcm_order_of_cora(n)
    # row inverse[v] of the reordered graph holds node v
    inverse = torch.from_numpy(np.argsort(order))
    np.testing.assert_allclose(out_t[inverse].numpy(), out_p[:n].numpy(),
                               rtol=0, atol=1e-5 * scale)
    # features, labels and splits moved with their nodes
    assert torch.equal(dt.features[:n], plain.features[:n][order])
    assert torch.equal(dt.labels[:n], plain.labels[:n][order])
    assert torch.equal(dt.idx_train.long(), inverse[plain.idx_train.long()])


def _rcm_order_of_cora(n):
    """The RCM order (``order[new] = old``) of Cora as the loader computes
    it: over the CSR of the normalised adjacency with self-loops."""
    from pygat_tpu_torch.data.preprocess import (
        normalize_adj_with_self_loops,
        symmetrize,
    )

    adj = tcitation._load_cora(tcitation._search_roots(None))[0]
    csr = normalize_adj_with_self_loops(symmetrize(adj)).tocsr()
    return tnative.rcm_order(csr.indptr, csr.indices, n)
