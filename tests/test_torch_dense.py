"""The port's dense GAT / GATv2 layers and model against the JAX package:
each layer with the same numpy dropout masks (dropout on and off, concat x
skip), values and gradients; the whole dense model in eval through
``params_from_jax``; the head-sequential rematerialized path against the
batched one (dropout on, the same masks) and against the JAX package's; the
dense adjacency; and the dense init's xavier-uniform bounds."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygat_tpu.graph import build_graph as jbuild_graph
from pygat_tpu.models import gat as jgat
from pygat_tpu.models import layers as jlayers
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from pygat_tpu_torch.graph import build_graph as tbuild_graph
from pygat_tpu_torch.models import gat as tgat
from pygat_tpu_torch.models import layers as tlayers
from pygat_tpu_torch.models.convert import params_from_jax
from pygat_tpu_torch.utils.platform import make_generator

VAL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)
F_IN, F_OUT, P = 12, 6, 0.5


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(11)
    n = 200
    s = np.concatenate([rng.integers(0, n, n * 5), np.arange(n)])
    r = np.concatenate([rng.integers(0, n, n * 5), np.arange(n)])
    w = rng.random(s.shape[0]).astype(np.float32) + 0.1
    gj = jbuild_graph(s, r, w, n)
    gt = tbuild_graph(s, r, w, n, device="cpu")
    x = rng.standard_normal((gj.num_nodes_padded, F_IN)).astype(np.float32)
    return gj, gt, x, rng


def test_to_dense_matches_jax(setup):
    gj, gt, _, _ = setup
    for binary in (False, True):
        np.testing.assert_array_equal(gt.to_dense(binary).numpy(),
                                      np.asarray(gj.to_dense(binary)))


def _layer_params(lt, rng, skip):
    w_rows = 2 * F_IN if lt == "GATv2" else F_IN
    a_len = F_OUT if lt == "GATv2" else 2 * F_OUT
    return ((rng.standard_normal((w_rows, F_OUT)) * 0.4).astype(np.float32),
            (rng.standard_normal(a_len) * 0.4).astype(np.float32),
            (rng.standard_normal((F_IN, F_OUT)) * 0.4).astype(np.float32)
            if skip else None)


def _masks(lt, n, rng):
    def m(*shape):
        return rng.random(shape) < 1.0 - P
    return (m(n, F_IN), m(n, F_OUT), m(n, F_OUT) if lt == "GATv2" else None,
            m(n, n))


@pytest.mark.parametrize("drop", [0.0, P], ids=["eval", "dropout"])
@pytest.mark.parametrize("concat,skip", [(True, True), (True, False),
                                         (False, True), (False, False)])
@pytest.mark.parametrize("lt", ["GAT", "GATv2"])
def test_dense_layer_matches_jax(setup, lt, concat, skip, drop):
    """One dense layer, the same parameters and (with dropout) the same
    boolean keep masks in both packages: output, and the gradients of
    sum(sin(out)) / N with respect to W, a, skip and the input."""
    gj, gt, x, rng = setup
    n = gj.num_nodes_padded
    params = _layer_params(lt, rng, skip)
    masks = _masks(lt, n, rng) if drop else (None,) * 4
    train = drop > 0
    jfn = jlayers.gat_v2_dense if lt == "GATv2" else jlayers.gat_v1_dense
    jcls = jlayers.V2Params if lt == "GATv2" else jlayers.V1Params
    adj_j = gj.to_dense(binary=True) > 0
    jm = jlayers.DropoutMasks(*(None if m is None else jnp.asarray(m)
                                for m in masks))

    def jloss(p, h):
        out = jfn(jcls(*p), h, adj_j, jm, alpha=0.2, drop=drop,
                  concat=concat, train=train)
        return jnp.sum(jnp.sin(out)) / n, out

    (_, out_j), grads_j = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
            tuple(None if t is None else jnp.asarray(t) for t in params),
            jnp.asarray(x))

    tfn = tlayers.gat_v2_dense if lt == "GATv2" else tlayers.gat_v1_dense
    tcls = tlayers.V2Params if lt == "GATv2" else tlayers.V1Params
    tp = [None if t is None else torch.tensor(t, requires_grad=True)
          for t in params]
    h = torch.tensor(x, requires_grad=True)
    tm = tlayers.DropoutMasks(*(None if m is None else torch.from_numpy(m)
                                for m in masks))
    out_t = tfn(tcls(*tp), h, gt.to_dense(binary=True) > 0, tm, alpha=0.2,
                drop=drop, concat=concat, train=train)
    (torch.sin(out_t).sum() / n).backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               **VAL)
    for got, want in zip([*tp, h], [*grads_j[0], grads_j[1]]):
        if got is None:
            continue
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), **GRAD)


def _cfgs(lt):
    kw = dict(nlayers=2, nheads=(3, 2), nfeats=(F_IN, 6, 4), dropout=0.6,
              alpha=0.2, layer_type=lt, skip_connection=True)
    return jgat.GATConfig(**kw), tgat.GATConfig(**kw)


@pytest.fixture(scope="module")
def jax_models(setup):
    """The JAX dense model of each type in eval, heads batched, once per
    module: (params as numpy, output, gradients of sum(sin(out)) / N). Its
    own tests hold its rematerialized heads to its batched ones."""
    gj, _, x, _ = setup
    cache = {}

    def get(lt):
        if lt not in cache:
            cfg_j, _ = _cfgs(lt)
            jparams = jgat.init_gat(jax.random.PRNGKey(2), cfg_j)

            def loss(p):
                out = jgat.apply_gat(p, cfg_j, jnp.asarray(x), gj,
                                     jax.random.PRNGKey(0), train=False)
                return jnp.sum(jnp.sin(out)) / out.shape[0], out

            (_, out), grads = jax.jit(jax.value_and_grad(
                loss, has_aux=True))(jparams)
            cache[lt] = (
                [tuple(None if t is None else np.asarray(t) for t in p)
                 for p in jparams],
                np.asarray(out),
                [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)])
        return cache[lt]

    return get


def _torch_model(setup, lt, numpy_params, monkeypatch, thresh):
    _, gt, x, _ = setup
    _, cfg_t = _cfgs(lt)
    monkeypatch.setattr(tgat, "_DENSE_VMAP_BYTES", thresh)
    params = params_from_jax(numpy_params, device="cpu")
    out = tgat.apply_gat(params, cfg_t, torch.from_numpy(x), gt, None,
                         train=False)
    (torch.sin(out).sum() / out.shape[0]).backward()
    return out.detach().numpy(), [p.grad.numpy()
                                  for p in tgat.parameters(params)]


@pytest.mark.parametrize("remat", [False, True], ids=["batched", "remat"])
@pytest.mark.parametrize("lt", ["GAT", "GATv2"])
def test_apply_gat_dense_matches_jax(setup, jax_models, lt, remat,
                                     monkeypatch):
    """The two-layer dense model (3 + 2 heads, skip connections) in eval,
    forward and parameter gradients, with the port's heads batched and
    with each head rematerialized (threshold 0), against the JAX model."""
    numpy_params, out_j, grads_j = jax_models(lt)
    out_t, grads_t = _torch_model(setup, lt, numpy_params, monkeypatch,
                                  0 if remat else 2 << 30)
    np.testing.assert_allclose(out_t, out_j, **VAL)
    assert len(grads_t) == len(grads_j)
    for got, want in zip(grads_t, grads_j):
        np.testing.assert_allclose(got, want, **GRAD)


@pytest.mark.parametrize("lt", ["GAT", "GATv2"])
def test_remat_matches_batched_under_dropout(setup, lt, monkeypatch):
    """With dropout on and the same masks, the rematerialized heads give the
    batched heads' output and gradients: the masks apply_gat draws for the
    remat path (before the checkpointed function) are recorded and fed to
    the batched path, and the backward's recompute reads them again. In
    float64: in float32 the two differ by the reassociation of a batched
    against a per-head product, which the softmax of dropout-scaled logits
    amplifies to about 1e-5 of the gradients."""
    _, gt, x, _ = setup
    _, cfg = _cfgs(lt)
    params = [type(p)(*(None if t is None else
                        t.detach().double().requires_grad_() for t in p))
              for p in tgat.init_gat(cfg, make_generator("cpu", 3),
                                     device="cpu")]
    x64 = torch.from_numpy(x).double()
    drawn = []
    real = tgat.draw_masks

    def spy(*a, **k):
        drawn.append(real(*a, **k))
        return drawn[-1]

    monkeypatch.setattr(tgat, "draw_masks", spy)
    monkeypatch.setattr(tgat, "_DENSE_VMAP_BYTES", 0)
    out_r = tgat.apply_gat(params, cfg, x64, gt, make_generator("cpu", 4),
                           train=True)
    (torch.sin(out_r).sum() / out_r.shape[0]).backward()
    grads_r = [p.grad.clone() for p in tgat.parameters(params)]
    assert len(drawn) == sum(cfg.nheads)  # one draw per head, outside

    # the same masks, stacked per layer, through the batched heads
    for p in tgat.parameters(params):
        p.grad = None
    neighborhood = gt.to_dense(binary=True) > 0
    h, start = x64, 0
    for i, p in enumerate(params):
        per_head = drawn[start:start + p.W.shape[0]]
        start += p.W.shape[0]
        stacked = tlayers.DropoutMasks(*(
            None if ms[0] is None else torch.stack(ms)
            for ms in zip(*per_head)))
        outs = tgat.dense_heads(cfg, p, h, neighborhood, stacked,
                                concat=i == 0, train=True, remat=False)
        h = (outs.permute(1, 0, 2).reshape(h.shape[0], -1) if i == 0
             else outs.mean(0))
    (torch.sin(h).sum() / h.shape[0]).backward()
    np.testing.assert_allclose(out_r.detach().numpy(), h.detach().numpy(),
                               **VAL)
    for got, p in zip(grads_r, tgat.parameters(params)):
        np.testing.assert_allclose(got.numpy(), p.grad.numpy(), **GRAD)
    with torch.no_grad():
        out_eval = tgat.apply_gat(params, cfg, x64, gt, None, train=False)
    assert not np.allclose(out_r.detach().numpy(), out_eval.numpy())


@pytest.mark.parametrize("lt", ["GAT", "GATv2"])
def test_dense_init_is_xavier_uniform(lt):
    """The dense types draw W and a from xavier uniform (the sparse ones
    from xavier normal), at the JAX package's shapes."""
    cfg = tgat.GATConfig(nlayers=1, nheads=(16,), nfeats=(64, 32),
                         dropout=0.0, alpha=0.2, layer_type=lt)
    (p,) = tgat.init_gat(cfg, make_generator("cpu", 0), device="cpu")
    jp = jax.eval_shape(lambda k: jgat.init_gat(k, jgat.GATConfig(*cfg)),
                        jax.random.PRNGKey(0))[0]
    for got, want, fan in zip(p[:2], jp[:2], (
            (128 + 32, 32 + 1) if lt == "GATv2" else (64 + 32, 64 + 1))):
        assert got.shape == want.shape
        bound = 1.414 * np.sqrt(6.0 / fan)
        t = got.detach()
        assert float(t.abs().max()) <= bound
        # uniform on [-b, b], of std b / sqrt(3); xavier normal, of the
        # same std, would pass b
        np.testing.assert_allclose(float(t.std()), bound / np.sqrt(3),
                                   rtol=0.1)
        assert float(t.abs().max()) > 0.9 * bound
    assert tgat.param_count([p]) == sum(int(np.prod(t.shape)) for t in jp
                                        if t is not None)


def test_dropout_and_drawn_masks(setup):
    """``dropout`` is inverted dropout (kept entries scaled by 1/(1-p), the
    rest 0; eval and p = 0 leave the input); a layer given a generator in
    place of masks draws its own (unbatched) ones."""
    _, gt, x, _ = setup
    h = torch.from_numpy(x)
    gen = make_generator("cpu", 9)
    out = tlayers.dropout(h, 0.5, gen, train=True)
    kept = out != 0
    assert 0.45 < float(kept.float().mean()) < 0.55
    torch.testing.assert_close(out[kept], 2 * h[kept])
    assert tlayers.dropout(h, 0.5, gen, train=False) is h
    assert tlayers.dropout(h, 0.0, gen, train=True) is h
    m = tlayers.draw_masks(gen, "GATv2", 0.5, n=8, f_in=3, f_out=2, e=0,
                           heads=4)
    assert [t.shape for t in m] == [(4, 8, 3), (4, 8, 2), (4, 8, 2),
                                    (4, 8, 8)]
    assert tlayers.draw_masks(gen, "GAT_sparse", 0.5, n=8, f_in=3, f_out=2,
                              e=40).m_att.shape == (40,)
    params = tlayers.V1Params(*(torch.tensor(t) for t in _layer_params(
        "GAT", np.random.default_rng(1), False)[:2]), None)
    adj = gt.to_dense(binary=True) > 0
    kw = dict(alpha=0.2, drop=0.5, concat=True)
    train = tlayers.gat_v1_dense(params, h, adj, make_generator("cpu", 2),
                                 train=True, **kw)
    again = tlayers.gat_v1_dense(params, h, adj, make_generator("cpu", 2),
                                 train=True, **kw)
    evald = tlayers.gat_v1_dense(params, h, adj, None, train=False, **kw)
    assert torch.isfinite(train).all() and torch.equal(train, again)
    assert not torch.allclose(train, evald)
