"""The BCSR fused attention of the PyTorch port (``pygat_tpu_torch/
legacy_bcsr``) against the JAX package's ``tests/legacy_bcsr``: the tiling
field for field, ``gat_attention_v1`` by both routes (on the CPU the fused
route runs the kernel's plain version) against ``_xla_forward``, and its
gradients against ``_fused_bwd`` on the same residuals and cotangent and
against ``jax.grad`` of ``_xla_forward``, with dropout off and with one
keep mask fed to both packages. The interpret-mode Pallas kernel is not
run: ``tests/test_kernels.py`` holds it against ``_xla_forward``."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygat_tpu.graph import build_graph as jbuild_graph
from tests.legacy_bcsr import sparse_attention as jsa
from tests.legacy_bcsr import tiles as jtiles
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from pygat_tpu_torch.graph import build_graph as tbuild_graph
from pygat_tpu_torch.legacy_bcsr import fused_attention as tfa
from pygat_tpu_torch.legacy_bcsr import sparse_attention as tsa
from pygat_tpu_torch.legacy_bcsr import tiles as ttiles

ALPHA = 0.2
KEEP = 0.6  # keep probability of the shared dropout mask (p = 0.4)
FIELDS = ("chunk_row", "chunk_col", "chunk_last", "recv_local", "send_local",
          "valid", "edge_perm")


def _edges(kind):
    """(senders, receivers, n, n_pad) of a test graph, from one seed."""
    rng = np.random.default_rng(3)
    n = 300
    loops = np.arange(n)
    if kind == "random":  # every (I, J) pair holds about 200 edges
        s, r = rng.integers(0, n, n * 6), rng.integers(0, n, n * 6)
    elif kind == "empty_row_tile":  # no receiver in [128, 256)
        n = 383
        r = np.concatenate([rng.integers(0, 128, 700),
                            rng.integers(256, n, 700)])
        s = rng.integers(0, n, 1400)
        return s, r, n, 384
    else:  # "dense_pair": 400 edges from tile 1 to tile 0, one tile pair
        s, r = rng.integers(128, 256, 400), rng.integers(0, 128, 400)
    return (np.concatenate([s, loops]), np.concatenate([r, loops]), n, None)


@functools.lru_cache(maxsize=None)
def _graphs(kind):
    s, r, n, n_pad = _edges(kind)
    gj = jbuild_graph(s, r, None, n, n_pad=n_pad)
    gt = tbuild_graph(s, r, None, n, n_pad=n_pad, device="cpu")
    np.testing.assert_array_equal(gt.senders.numpy(), np.asarray(gj.senders))
    return gj, gt


@pytest.mark.parametrize("kind,pad_to", [("random", None), ("random", 40),
                                         ("empty_row_tile", None),
                                         ("dense_pair", None)])
def test_tile_graph_matches_jax(kind, pad_to):
    gj, gt = _graphs(kind)
    want = jtiles.tile_graph(gj, pad_chunks_to=pad_to)
    got = ttiles.tile_graph(gt, pad_chunks_to=pad_to)
    for name in FIELDS:
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got.n_tiles == want.n_tiles
    assert ttiles.tile_stats(got) == jtiles.tile_stats(want)
    rows = got.chunk_row.numpy()
    assert set(rows.tolist()) == set(range(got.n_tiles))  # no tile missing
    if pad_to:
        assert got.num_chunks == pad_to
    if kind == "dense_pair":  # 400 edges of one pair: 4 chunks, 3 full
        pair = (rows == 0) & (got.chunk_col.numpy() == 1)
        assert got.valid.numpy()[pair].sum(1).tolist() == [128, 128, 128, 16]


def _inputs(g, h, f, seed):
    rng = np.random.default_rng(seed)
    n = g.num_nodes_padded
    return dict(
        fd=rng.standard_normal((h, n)).astype(np.float32),
        fs=rng.standard_normal((h, n)).astype(np.float32),
        wh=rng.standard_normal((h, n, f)).astype(np.float32),
        ct=rng.standard_normal((h, n, f)).astype(np.float32),
        keep=(rng.random(g.num_edges_padded) < KEEP).astype(np.float32) / KEEP)


@functools.lru_cache(maxsize=None)
def _jax_case(kind, h, f, dropout):
    """The JAX side at one shape: ``_xla_forward``, its ``jax.grad`` (as a
    vjp of the cotangent), and ``_fused_bwd`` on the same residuals, each
    jitted once."""
    gj, _ = _graphs(kind)
    x = _inputs(gj, h, f, 10 * h + f)
    keep = jnp.asarray(x["keep"]) if dropout else None
    args = (gj.senders, gj.receivers, gj.edge_mask, ALPHA)

    @jax.jit
    def fwd_and_vjp(fd, fs, wh, ct):
        out, vjp = jax.vjp(lambda a, b, c: jsa._xla_forward(
            a, b, c, *args, keep_scaled=keep, row_ptr=gj.row_ptr), fd, fs, wh)
        return out, vjp(ct)

    @jax.jit
    def fused_bwd(fd, fs, wh, ct):
        ks = keep if dropout else jsa.edge_ones(gj)
        res = (fd, fs, wh, ks, gj.senders, gj.receivers, gj.edge_mask,
               gj.row_ptr, gj.col_perm, gj.col_ptr)
        return jsa._fused_bwd(ALPHA, True, "highest", res, ct)[:3]

    j = {k: jnp.asarray(x[k]) for k in ("fd", "fs", "wh", "ct")}
    out, grads = fwd_and_vjp(j["fd"], j["fs"], j["wh"], j["ct"])
    fused = fused_bwd(j["fd"], j["fs"], j["wh"], j["ct"])
    return x, np.asarray(out), [np.asarray(a) for a in grads], [
        np.asarray(a) for a in fused]


def _port(kind, x, backend, dropout):
    """The port's output and gradients of f_dst, f_src and wh."""
    _, gt = _graphs(kind)
    tiles = ttiles.tile_graph(gt) if backend == "pallas" else None
    leaves = [torch.tensor(x[k], requires_grad=True) for k in ("fd", "fs", "wh")]
    out = tsa._gat_attention_v1(
        *leaves, gt, tiles, alpha=ALPHA, backend=backend,
        keep_scaled=torch.from_numpy(x["keep"]) if dropout else None)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(x["ct"]))
    return out.detach().numpy(), [a.numpy() for a in grads]


def _forward_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(want).max())))


def _grads_close(got, want, what):
    for name, a, b in zip(("f_dst", "f_src", "wh"), got, want):
        scale = float(np.abs(b).max())
        np.testing.assert_allclose(a, b, rtol=0, atol=5e-5 * scale,
                                   err_msg=f"{name} vs {what}")


CASES = [(2, 8, False), (2, 8, True), (1, 7, False), (1, 7, True)]


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("h,f,dropout", CASES)
def test_gat_attention_v1_matches_jax(backend, h, f, dropout):
    x, out_j, grads_j, fused_j = _jax_case("random", h, f, dropout)
    out_t, grads_t = _port("random", x, backend, dropout)
    _forward_close(out_t, out_j)
    _grads_close(grads_t, fused_j, "_fused_bwd")
    _grads_close(grads_t, grads_j, "jax.grad of _xla_forward")


def test_fused_route_on_an_empty_row_tile():
    """A row tile with no edge gets its one empty chunk: zero output rows
    there, and the fused route equals the segment-op route elsewhere."""
    _, gt = _graphs("empty_row_tile")
    x = _inputs(gt, 2, 8, 5)
    tiles = ttiles.tile_graph(gt)
    args = [torch.from_numpy(x[k]) for k in ("fd", "fs", "wh")]
    out, m, den = tfa.bcsr_attention(*args, tiles, ALPHA)
    want = tsa._gat_attention_v1(*args, gt, None, alpha=ALPHA)
    _forward_close(out.numpy(), want.numpy())
    assert not out[:, 128:256].any() and not den[:, 128:256].any()
    assert not m[:, 128:256].any()


def test_fused_attention_numerical_stability():
    """f_dst = f_src = 300, as tests/test_kernels.py checks the Pallas
    kernel: the fused route stays finite, forward and backward, and equals
    ``_xla_forward``."""
    gj, gt = _graphs("random")
    rng = np.random.default_rng(9)
    n = gt.num_nodes_padded
    wh = rng.standard_normal((1, n, 128)).astype(np.float32)
    want = jax.jit(lambda w: jsa._xla_forward(
        jnp.full((1, n), 300.0), jnp.full((1, n), 300.0), w, gj.senders,
        gj.receivers, gj.edge_mask, ALPHA))(jnp.asarray(wh))
    leaves = [torch.full((1, n), 300.0, requires_grad=True),
              torch.full((1, n), 300.0, requires_grad=True),
              torch.tensor(wh, requires_grad=True)]
    out = tsa.gat_attention_v1(*leaves, gt, ttiles.tile_graph(gt),
                               alpha=ALPHA, backend="pallas")
    grads = torch.autograd.grad(out.sum(), leaves)
    assert torch.isfinite(out).all()
    assert all(torch.isfinite(a).all() for a in grads)
    _forward_close(out.detach().numpy(), np.asarray(want))


def test_dropout_draws_one_mask_from_the_generator():
    """gat_attention_v1 draws one keep mask from the generator, so both
    routes agree under the same seed, and differ from no dropout."""
    _, gt = _graphs("random")
    x = _inputs(gt, 2, 8, 6)
    tiles = ttiles.tile_graph(gt)
    args = [torch.from_numpy(x[k]) for k in ("fd", "fs", "wh")]
    outs = [tsa.gat_attention_v1(
        *args, gt, tiles, alpha=ALPHA, backend=backend, dropout_rate=0.5,
        generator=torch.Generator().manual_seed(7), train=True)
        for backend in ("pallas", "xla")]
    _forward_close(outs[0].numpy(), outs[1].numpy())
    plain = tsa.gat_attention_v1(*args, gt, tiles, alpha=ALPHA,
                                 backend="pallas")
    assert float((outs[0] - plain).abs().max()) > 1e-3
    with pytest.raises(ValueError, match="generator"):
        tsa.gat_attention_v1(*args, gt, tiles, alpha=ALPHA, dropout_rate=0.5,
                             train=True)


def test_the_reference_value_errors():
    _, gt = _graphs("random")
    x = _inputs(gt, 1, 4, 7)
    args = [torch.from_numpy(x[k]) for k in ("fd", "fs", "wh")]
    tiles = ttiles.tile_graph(gt)
    with pytest.raises(ValueError, match="requires a TiledGraph"):
        tsa.gat_attention_v1(*args, gt, None, alpha=ALPHA, backend="pallas")
    for field in ("col_perm", "col_ptr"):
        with pytest.raises(ValueError, match="CSC view"):
            tsa.gat_attention_v1(*args, gt._replace(**{field: None}), tiles,
                                 alpha=ALPHA, backend="pallas")
    with pytest.raises(ValueError, match="precision"):
        tfa.fused_gat_attention_fwd(*args, tiles, alpha=ALPHA,
                                    precision="fastest")
    assert tfa.head_feature_pad(8, 8) == 16 and tfa.head_feature_pad(1, 7) == 128
