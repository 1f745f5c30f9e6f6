"""The port's ring partition and its per-hop attention on the CPU, against
the JAX package: ``partition_edges`` array for array (2 and 4 shards with
their halo fields, one shard without, the dense-packed layout, an empty
block), each block's walks, ``repad_citation`` and
``interleave_citation``, and the per-hop ops ``fused_v1_attention_parts``
and ``fused_v2_attention_parts`` forward and VJP against the JAX ones
(interpret mode, ``high`` precision) on a halo block whose sender buffer has
fewer rows than the shard. Also the single-process edges of the
distributed layer: the collectives without a group, the launcher checks
and the CLIs' refusals."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygat_tpu.data import citation as jcit
from pygat_tpu.graph import build_graph as jbuild_graph
from pygat_tpu.ops import fused_stream as jfs
from pygat_tpu.parallel import partition as jpart
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from pygat_tpu_torch.cli import train as tcli
from pygat_tpu_torch.cli import train_ppi as tcli_ppi
from pygat_tpu_torch.data import citation as tcit
from pygat_tpu_torch.graph import build_graph as tbuild_graph
from pygat_tpu_torch.ops import fused_stream as tfs
from pygat_tpu_torch.ops.stream import build_stream_walk
from pygat_tpu_torch.parallel import collectives as col
from pygat_tpu_torch.parallel import mesh as tmesh
from pygat_tpu_torch.parallel import partition as tpart

ALPHA = 0.2


def _edges(n, degree, seed, drop=None):
    """A random graph with self loops; ``drop`` = (sender range, receiver
    range) removes every edge between them (an empty block)."""
    rng = np.random.default_rng(seed)
    s = np.concatenate([rng.integers(0, n, n * degree), np.arange(n)])
    r = np.concatenate([rng.integers(0, n, n * degree), np.arange(n)])
    if drop is not None:
        (s0, s1), (r0, r1) = drop
        keep = ~((s >= s0) & (s < s1) & (r >= r0) & (r < r1))
        s, r = s[keep], r[keep]
    return s, r


# (n, n_pad, shards, degree, empty block): 2 and 4 stream-aligned shards
# (halo fields), one shard (none), 192-row shards (dense-packed)
LAYOUTS = {"d2": (400, 512, 2, 5, None),
           "d4_empty_block": (400, 512, 4, 5, ((128, 256), (256, 384))),
           "d1": (300, 384, 1, 5, None),
           "d2_dense_packed": (300, 384, 2, 5, None)}


@pytest.fixture(scope="module", params=list(LAYOUTS))
def layout(request):
    n, n_pad, d, degree, drop = LAYOUTS[request.param]
    s, r = _edges(n, degree, 11, drop)
    jg = jbuild_graph(s, r, None, n, n_pad=n_pad)
    tg = tbuild_graph(s, r, None, n, n_pad=n_pad, device="cpu")
    return request.param, jpart.partition_edges(jg, d), \
        tpart.partition_edges(tg, d)


def test_partition_edges_equals_jax(layout):
    name, jp, tp = layout
    for field in tp._fields:
        want, got = getattr(jp, field), getattr(tp, field)
        if want is None or isinstance(want, int):
            assert got == want, field
        else:
            np.testing.assert_array_equal(got, np.asarray(want),
                                          err_msg=field)
    assert tp.has_halo == (tp.n_shards > 1 and tp.has_stream)
    assert tp.has_stream == (name != "d2_dense_packed")
    if name == "d4_empty_block":
        assert not tp.edge_mask[2, 1].any()


def test_shard_blocks_carry_each_blocks_walks(layout):
    """Every block's receiver walk, sender-view walk and halo-view walk is
    ``build_stream_walk`` of its arrays; an empty block's walk holds no
    slot and its halo chunks are the dead chunk map."""
    name, _, tp = layout
    if not tp.has_stream:
        with pytest.raises(ValueError, match="stream-aligned"):
            tpart.shard_blocks(tp, 0, "cpu")
        return
    d, n_tiles = tp.n_shards, tp.n_local // 128
    for dst in range(d):
        sb = tpart.shard_blocks(tp, dst, "cpu")
        for src in range(d):
            views = [(sb.recv_walks[src], tp.local, tp.chunk, n_tiles),
                     (sb.send_walks[src], tp.s_local, tp.s_chunk, n_tiles)]
            if tp.has_halo and src != dst:
                views.append((sb.halo_walks[src], tp.h_local, tp.h_chunk,
                              tp.h_rows // 128))
            for walk, local, chunk, tiles in views:
                ref = build_stream_walk(local[dst, src], chunk[dst, src],
                                        tiles, "cpu")
                for f in ("row_ptr", "tile_ptr", "split_at"):
                    assert torch.equal(getattr(walk, f), getattr(ref, f))
                assert walk.max_run == ref.max_run
    if name == "d4_empty_block":
        sb = tpart.shard_blocks(tp, 2, "cpu")
        assert sb.recv_walks[1].max_run == 0
        assert not sb.recv_walks[1].tile_ptr.any()
        assert sb.halo_walks[1].max_run == 0


def _datasets(n, n_pad, seed):
    rng = np.random.default_rng(seed)
    s, r = _edges(n, 4, seed)
    x = np.zeros((n_pad, 24), np.float32)
    x[:n] = rng.random((n, 24), dtype=np.float32)
    labels = np.full(n_pad, -1, np.int32)
    labels[:n] = rng.integers(0, 4, n)
    idx = [np.arange(a, b, dtype=np.int32) for a, b in
           ((0, 40), (40, 100), (100, n))]
    jds = jcit.CitationDataset(jbuild_graph(s, r, None, n, n_pad=n_pad),
                               jnp.asarray(x), jnp.asarray(labels),
                               *map(jnp.asarray, idx), 4, 24, ())
    tds = tcit.CitationDataset(
        tbuild_graph(s, r, None, n, n_pad=n_pad, device="cpu"),
        torch.from_numpy(x), torch.from_numpy(labels),
        *map(torch.from_numpy, idx), 4, 24, ())
    return jds, tds


def _same_dataset(tds, jds):
    for f in tds.graph._fields:
        np.testing.assert_array_equal(getattr(tds.graph, f).numpy(),
                                      np.asarray(getattr(jds.graph, f)),
                                      err_msg=f)
    for f in ("features", "labels", "idx_train", "idx_val", "idx_test"):
        np.testing.assert_array_equal(getattr(tds, f).numpy(),
                                      np.asarray(getattr(jds, f)), err_msg=f)
    # rebuilt by build_graph: the walks came with it
    assert tds.graph.stream_walk is not None
    assert tds.graph.sender_walk is not None


@pytest.mark.parametrize("n_pad", [512, 384], ids=["grow", "same"])
def test_repad_citation_equals_jax(n_pad):
    jds, tds = _datasets(300, 384, 3)
    _same_dataset(tcit.repad_citation(tds, n_pad),
                  jcit.repad_citation(jds, n_pad))


@pytest.mark.parametrize("d", [2, 4])
def test_interleave_citation_equals_jax(d):
    jds, tds = _datasets(300, 384, 4)
    got = tcit.interleave_citation(tds, d, n_pad=512)
    _same_dataset(got, jcit.interleave_citation(jds, d, n_pad=512))
    # the real rows are a prefix of each shard, not of the graph
    mask = got.graph.node_mask.view(d, -1)
    assert all(mask[k, :int(mask[k].sum())].all() for k in range(d))
    assert not got.graph.node_mask[:300].all()


@pytest.fixture(scope="module")
def halo_block():
    """Block (dst 0, src 1) of a 2-shard partition of 900 nodes over 1,024
    rows: its halo buffer has fewer rows than the 512-row shard."""
    s, r = _edges(900, 2, 21)
    tg = tbuild_graph(s, r, None, 900, n_pad=1024, device="cpu")
    tp = tpart.partition_edges(tg, 2)
    assert tp.h_rows < tp.n_local
    return tp, tpart.shard_blocks(tp, 0, "cpu").block(1, halo=True)


def _parts_inputs(n_local, n_buf, e, h, f, seed):
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return (rng.standard_normal(shape) * 0.5).astype(np.float32)

    keepq = np.where(rng.random((e, h)) < 0.6, 1.0 / 0.6, 0.0).astype(
        np.float32)
    return rnd, keepq


@pytest.mark.parametrize("h,f", [(2, 8), (1, 5)])
def test_fused_v1_attention_parts_matches_jax(halo_block, h, f):
    tp, blk = halo_block
    n_local, n_buf, e = tp.n_local, blk.n_rows, blk.recv.shape[0]
    rnd, keepq = _parts_inputs(n_local, n_buf, e, h, f, h * 10 + f)
    f_dst, w_buf, a_src = rnd(n_local, h), rnd(n_buf, h * f), rnd(h, f)
    f_src = (w_buf.reshape(n_buf, h, f) * a_src).sum(-1).max(0)
    raw = f_dst + f_src
    bound = np.where(raw >= 0, raw, ALPHA * raw).astype(np.float32)
    g_out, g_den = rnd(n_local, h * f), rnd(n_local, h)
    fields = [np.asarray(t) for t in (blk.senders, blk.recv, blk.local,
                                      blk.chunk, blk.s_slot, blk.s_local,
                                      blk.s_chunk)]

    @jax.jit  # interpret mode op by op costs several times the compile
    def run(f_dst_, w_buf_, a_src_):
        def fn(fd, w, a):
            return jfs.fused_v1_attention_parts(
                fd, jnp.asarray(bound), w, a, jnp.asarray(keepq),
                *map(jnp.asarray, fields), ALPHA, "high", True)
        (out, den), vjp = jax.vjp(fn, f_dst_, w_buf_, a_src_)
        return out, den, vjp((jnp.asarray(g_out), jnp.asarray(g_den)))

    out_j, den_j, grads_j = run(*map(jnp.asarray, (f_dst, w_buf, a_src)))
    leaves = [torch.tensor(v, requires_grad=True)
              for v in (f_dst, w_buf, a_src)]
    out_t, den_t = tfs.fused_v1_attention_parts(
        leaves[0], torch.from_numpy(bound), leaves[1], leaves[2],
        torch.from_numpy(keepq), blk.senders, blk.recv, blk.local, blk.chunk,
        blk.s_slot, blk.s_local, blk.s_chunk, ALPHA, blk.walk,
        blk.sender_walk)
    grads_t = torch.autograd.grad((out_t, den_t), leaves,
                                  (torch.from_numpy(g_out),
                                   torch.from_numpy(g_den)))
    _held(out_t, den_t, grads_t, out_j, den_j, grads_j,
          ("f_dst", "w_buf", "a_src"))


def _held(out_t, den_t, grads_t, out_j, den_j, grads_j, names):
    # the tolerances of tests/test_torch_fused.py: the JAX 'high' kernel
    # keeps about 16 mantissa bits in its scatter, the port sums in f32
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(den_t.detach().numpy(), np.asarray(den_j),
                               atol=2e-4, rtol=1e-4)
    for name, gt, gj in zip(names, grads_t, grads_j):
        gj = np.asarray(gj)
        np.testing.assert_allclose(gt.numpy(), gj,
                                   atol=5e-5 * float(np.abs(gj).max()),
                                   err_msg=name)


@pytest.mark.parametrize("h,f", [(2, 8), (1, 5)])
def test_fused_v2_attention_parts_matches_jax(halo_block, h, f):
    tp, blk = halo_block
    n_local, n_buf, e = tp.n_local, blk.n_rows, blk.recv.shape[0]
    rnd, keepq = _parts_inputs(n_local, n_buf, e, h, f, h * 10 + f + 1)
    wi_local, wi_buf, wj_buf = (rnd(n_local, h * f), rnd(n_buf, h * f),
                                rnd(n_buf, h * f))
    a = rnd(h, f)
    # the sign-split bound of the ring over the buffer's rows
    mq_max, mq_min = wj_buf.max(0).reshape(h, f), wj_buf.min(0).reshape(h, f)
    wi3 = wi_local.reshape(n_local, h, f)

    def leaky(x):
        return np.where(x >= 0, x, ALPHA * x)

    ub = ((leaky(wi3 + mq_max) * np.maximum(a, 0)).sum(-1)
          + (leaky(wi3 + mq_min) * np.minimum(a, 0)).sum(-1)).astype(
              np.float32)
    g_out, g_den = rnd(n_local, h * f), rnd(n_local, h)
    fields = [np.asarray(t) for t in (blk.senders, blk.recv, blk.local,
                                      blk.chunk, blk.s_slot, blk.s_local,
                                      blk.s_chunk)]

    @jax.jit
    def run(wl, wib, wjb, a_):
        def fn(wl_, wib_, wjb_, aa):
            return jfs.fused_v2_attention_parts(
                wl_, jnp.asarray(ub), wib_, wjb_, aa, jnp.asarray(keepq),
                *map(jnp.asarray, fields), ALPHA, "high", True)
        (out, den), vjp = jax.vjp(fn, wl, wib, wjb, a_)
        return out, den, vjp((jnp.asarray(g_out), jnp.asarray(g_den)))

    out_j, den_j, grads_j = run(*map(jnp.asarray,
                                     (wi_local, wi_buf, wj_buf, a)))
    leaves = [torch.tensor(v, requires_grad=True)
              for v in (wi_local, wi_buf, wj_buf, a)]
    out_t, den_t = tfs.fused_v2_attention_parts(
        leaves[0], torch.from_numpy(ub), leaves[1], leaves[2], leaves[3],
        torch.from_numpy(keepq), blk.senders, blk.recv, blk.local, blk.chunk,
        blk.s_slot, blk.s_local, blk.s_chunk, ALPHA, blk.walk,
        blk.sender_walk)
    grads_t = torch.autograd.grad((out_t, den_t), leaves,
                                  (torch.from_numpy(g_out),
                                   torch.from_numpy(g_den)))
    _held(out_t, den_t, grads_t, out_j, den_j, grads_j,
          ("wi_local", "wi_buf", "wj_buf", "a"))


@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
def test_unfused_hop_matches_the_fused_hop(halo_block, v2):
    """A hop by the block gathers and sums (row 1 over the block's views)
    equals the hop by the parts op, forward and gradients."""
    from pygat_tpu_torch.ops.fused_stream import set_fused_attention

    tp, blk = halo_block
    sb = tpart.shard_blocks(tp, 0, "cpu")
    rng = np.random.default_rng(5)
    h, f = 2, 4
    t = {k: torch.tensor((rng.standard_normal(shape) * 0.5).astype(
        np.float32), requires_grad=True)
        for k, shape in (("local", (tp.n_local, h * f)),
                         ("bi", (blk.n_rows, h * f)),
                         ("bj", (blk.n_rows, h * f)), ("a", (h, f)),
                         ("fd", (tp.n_local, h)))}
    shift = torch.full((tp.n_local, h), 3.0)
    keep = torch.from_numpy(np.where(
        rng.random((2, blk.recv.shape[0], h)) < 0.6, 1 / 0.6, 0.0).astype(
            np.float32))
    results = []
    for mode in ("on", "off"):
        set_fused_attention(mode)
        try:
            acc = torch.zeros(tp.n_local, h * f + h)
            if v2:
                acc = tpart.ring_hop_v2(acc, t["bi"], t["bj"], 1, sb,
                                        t["local"], shift, t["a"], keep,
                                        alpha=ALPHA, halo=True)
            else:
                acc = tpart.ring_hop_v1(acc, t["bi"], 1, sb, t["fd"], shift,
                                        t["a"], keep, alpha=ALPHA, halo=True)
            grads = torch.autograd.grad(acc.square().sum(), list(t.values()),
                                        allow_unused=True)
        finally:
            set_fused_attention("auto")
        results.append((acc.detach(), grads))
    (acc_f, g_f), (acc_u, g_u) = results
    torch.testing.assert_close(acc_u, acc_f, rtol=1e-5, atol=1e-5)
    for a_, b_ in zip(g_u, g_f):
        if a_ is not None or b_ is not None:
            torch.testing.assert_close(a_, b_, rtol=1e-4, atol=1e-4)


def test_collectives_without_a_group():
    """One process, no group: the collectives are one rank's identity; the
    ring permute sends nothing and passes gradients through."""
    x = torch.arange(6.0).reshape(3, 2).requires_grad_()
    assert col.axis_size() == 1 and col.axis_index() == 0
    for fn in (col.all_reduce_sum, col.all_reduce_mean, col.all_reduce_max,
               col.all_reduce_min, col.all_gather):
        assert torch.equal(fn(x), x.detach())
    y = col.ppermute_ring(x, 3)
    y.sum().backward()
    assert torch.equal(y, x.detach()) and torch.equal(x.grad, torch.ones(3, 2))


def test_launcher_checks(monkeypatch):
    """No launcher environment: a single-process run (False); a partial
    one raises; a mesh, with a model axis or without, needs a process
    group."""
    for v in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(v, raising=False)
    assert tmesh.initialize_distributed(cpu=True) is False
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="lacks"):
        tmesh.initialize_distributed(cpu=True)
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh(2, 1, device="cpu")
    with pytest.raises(RuntimeError, match="needs a process group of 4"):
        tmesh.make_mesh(2, 2, device="cpu")


@pytest.mark.parametrize("cli,argv,what", [
    (tcli, ["--mesh", "2,1"], "process group"),
    (tcli, ["--distributed"], "process group"),
    (tcli, ["--mesh", "2,2"], "process group"),
    (tcli, ["--mesh", "2,1", "--model", "GAT"], "process group"),
    (tcli, ["--reorder", "--mesh", "2,1"], "process group"),
    (tcli, ["--partition", "ring"], "needs --mesh"),
    (tcli_ppi, ["--mesh", "2,1", "--model", "GAT_sparse"], "--epoch-scan"),
    (tcli_ppi, ["--mesh", "2,1", "--model", "GATv2", "--epoch-scan"],
     "process group"),
    (tcli_ppi, ["--mesh", "4,2", "--model", "GAT_sparse", "--epoch-scan"],
     "process group"),
], ids=["no_group", "distributed_no_group", "model_axis", "dense",
        "reorder", "partition_no_mesh", "ppi_per_batch", "ppi_dense", "ppi_model_axis"])
def test_clis_refuse_what_is_not_there(monkeypatch, cli, argv, what):
    for v in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(v, raising=False)
    with pytest.raises(SystemExit, match=what):
        cli.main([*argv, "--no-cuda", "--no-checkpoint", "--epochs", "1"])
