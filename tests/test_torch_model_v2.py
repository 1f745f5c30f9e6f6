"""The PyTorch port's GATv2_sparse model and train step against the JAX
package, with the same parameters (carried by ``params_from_jax``) and
dropout off: model output and parameter gradients through the fused path
(the JAX side in interpret mode at ``high``), and a 5-step loss trajectory
(the JAX train step on its CPU default, the unfused scatter path)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from pygat_tpu.graph import build_graph as jbuild_graph
from pygat_tpu.models import gat as jgat
from pygat_tpu.models import layers as jlayers
from pygat_tpu.ops import segment as jseg
from pygat_tpu.train import loop as jloop
from pygat_tpu.train import state as jstate
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from pygat_tpu_torch.graph import build_graph as tbuild_graph
from pygat_tpu_torch.models import gat as tgat
from pygat_tpu_torch.models import layers as tlayers
from pygat_tpu_torch.models.convert import params_from_jax
from pygat_tpu_torch.train import loop as tloop
from pygat_tpu_torch.train import state as tstate
from pygat_tpu_torch.utils.platform import make_generator


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(11)
    n = 200
    s = np.concatenate([rng.integers(0, n, n * 5), np.arange(n)])
    r = np.concatenate([rng.integers(0, n, n * 5), np.arange(n)])
    gj = jbuild_graph(s, r, None, n)
    gt = tbuild_graph(s, r, None, n, device="cpu")
    x = (rng.standard_normal((gj.num_nodes_padded, 24)) * 0.5).astype(np.float32)
    labels = np.full(gj.num_nodes_padded, -1, np.int32)
    labels[:n] = rng.integers(0, 4, n)
    return gj, gt, x, labels


def _cfg(skip: bool, dropout: float = 0.0):
    kw = dict(nlayers=2, nheads=(4, 2), nfeats=(24, 8, 4), dropout=dropout,
              alpha=0.2, layer_type="GATv2_sparse", skip_connection=skip)
    return jgat.GATConfig(**kw), tgat.GATConfig(**kw)


def _numpy_params(jparams):
    return [tuple(None if t is None else np.asarray(t) for t in p)
            for p in jparams]


@pytest.mark.parametrize("skip", [False, True])
def test_apply_gat_v2_matches_jax_fused(setup, skip):
    """Forward and parameter gradients of the whole model; the JAX side
    runs its fused Pallas path in interpret mode at 'high' precision."""
    gj, gt, x, _ = setup
    cfg_j, cfg_t = _cfg(skip)
    jparams = jgat.init_gat(jax.random.PRNGKey(0), cfg_j)

    def loss(p):
        with jseg.use_impl("stream"):
            out = jgat.apply_gat(p, cfg_j, jnp.asarray(x), gj,
                                 jax.random.PRNGKey(1), train=False)
        return jnp.sum(jnp.sin(out)), out

    prev = jseg._STREAM_PRECISION
    jseg._STREAM_PRECISION = "high"
    try:
        # jitted: interpret mode op by op costs several times the compile
        (_, out_j), grads_j = jax.jit(
            jax.value_and_grad(loss, has_aux=True))(jparams)
    finally:
        jseg._STREAM_PRECISION = prev

    tparams = params_from_jax(_numpy_params(jparams), device="cpu")
    assert all(isinstance(p, tlayers.V2Params) for p in tparams)
    out_t = tgat.apply_gat(tparams, cfg_t, torch.from_numpy(x), gt, None,
                           train=False)
    torch.sin(out_t).sum().backward()

    # tolerances of the GAT_sparse model test
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               atol=2e-4, rtol=1e-4)
    gj_flat = np.asarray(ravel_pytree(grads_j)[0])
    gt_flat = torch.cat([p.grad.reshape(-1)
                         for p in tgat.parameters(tparams)]).numpy()
    scale = float(np.abs(gj_flat).max())
    np.testing.assert_allclose(gt_flat, gj_flat, atol=5e-5 * scale)


def test_v2_five_step_loss_trajectory_matches_jax(setup):
    """Five Adam steps (L2 in the gradient) with dropout off: the same loss
    at every step as the JAX train step from the same parameters."""
    gj, gt, x, labels = setup
    cfg_j, cfg_t = _cfg(False)
    lr, wd = 0.01, 5e-4
    idx = np.arange(0, 120, dtype=np.int32)
    jparams = jgat.init_gat(jax.random.PRNGKey(0), cfg_j)

    tx = jstate.make_optimizer(lr, wd)
    js = jstate.init_state(jparams, tx, jax.random.PRNGKey(1))
    jstep, _ = jloop.make_transductive_steps(cfg_j, tx)
    losses_j = []
    for _ in range(5):
        js, loss, _, _ = jstep(js, jnp.asarray(x), gj, jnp.asarray(labels),
                               jnp.asarray(idx))
        losses_j.append(float(loss))

    tparams = params_from_jax(_numpy_params(jparams), device="cpu")
    ts = tstate.init_state(tparams, tstate.make_optimizer(tparams, lr, wd),
                           make_generator("cpu", 1))
    tstep, _ = tloop.make_transductive_steps(cfg_t)
    losses_t = []
    for _ in range(5):
        ts, loss, _, _ = tstep(ts, torch.from_numpy(x), gt,
                               torch.from_numpy(labels), torch.from_numpy(idx))
        losses_t.append(float(loss))
    assert ts.step == 5
    assert losses_t[-1] < losses_t[0]
    np.testing.assert_allclose(losses_t, losses_j, rtol=2e-5)
    flat_j = np.asarray(ravel_pytree(js.params)[0])
    flat_t = torch.cat([p.detach().reshape(-1)
                        for p in tgat.parameters(ts.params)]).numpy()
    np.testing.assert_allclose(flat_t, flat_j, atol=1e-5)


def test_v2_dropout_train_step_is_finite_and_seeded(setup):
    """With dropout, two steps from the same generator seed agree exactly
    and differ from another seed; losses are finite."""
    _, gt, x, labels = setup
    _, cfg_t = _cfg(True, dropout=0.6)
    idx = torch.arange(120, dtype=torch.int32)

    def run(seed):
        params = tgat.init_gat(cfg_t, make_generator("cpu", 0), device="cpu")
        st = tstate.init_state(params, tstate.make_optimizer(params, 0.01, 0.0),
                               make_generator("cpu", seed))
        step, _ = tloop.make_transductive_steps(cfg_t)
        return [float(step(st, torch.from_numpy(x), gt,
                           torch.from_numpy(labels), idx)[1])
                for _ in range(2)]

    a, b, c = run(5), run(5), run(6)
    assert all(np.isfinite(a))
    assert a == b and a != c


def test_v2_layer_draws_four_dropout_sites_in_order(setup):
    """Input, left projection, right projection, attention: the layer
    consumes exactly those four draws from the generator, in that order."""
    _, gt, x, _ = setup
    n, e = gt.num_nodes_padded, gt.num_edges_padded
    h, f_in, f_out = 2, 24, 3
    gen = make_generator("cpu", 3)
    params = tlayers.V2Params(torch.randn(h, 2 * f_in, f_out, generator=gen),
                              torch.randn(h, f_out, generator=gen), None)
    gen.manual_seed(9)
    out = tlayers.gat_v2_sparse_heads(params, torch.from_numpy(x), gt, gen,
                                      alpha=0.2, drop=0.5, concat=True,
                                      train=True)
    after = gen.get_state()
    assert out.shape == (n, h * f_out) and torch.isfinite(out).all()
    gen.manual_seed(9)
    for shape in ((n, h, f_in), (n, h * f_out), (n, h * f_out), (e, h)):
        torch.rand(shape, generator=gen)
    assert torch.equal(gen.get_state(), after)


def test_v2_init_shapes_and_fan_sums():
    """W [H, 2 F_in, F_out] with fan sum 2 F_in + F_out, a [H, F_out] with
    fan sum F_out + 1 (xavier normal, gain 1.414), as the JAX package."""
    cfg = tgat.GATConfig(nlayers=1, nheads=(16,), nfeats=(64, 32),
                         dropout=0.0, alpha=0.2, layer_type="GATv2_sparse",
                         skip_connection=True)
    (p,) = tgat.init_gat(cfg, make_generator("cpu", 0), device="cpu")
    assert isinstance(p, tlayers.V2Params)
    assert p.W.shape == (16, 128, 32) and p.a.shape == (16, 32)
    assert p.skip.shape == (16, 64, 32)
    assert all(t.requires_grad for t in p)
    np.testing.assert_allclose(float(p.W.detach().std()),
                               1.414 * np.sqrt(2.0 / (128 + 32)), rtol=0.03)
    np.testing.assert_allclose(float(p.a.detach().std()),
                               1.414 * np.sqrt(2.0 / (32 + 1)), rtol=0.1)


def test_params_from_jax_tells_the_layer_kinds_apart():
    w1, a1 = np.zeros((2, 5, 3), np.float32), np.zeros((2, 6), np.float32)
    w2, a2 = np.zeros((2, 10, 3), np.float32), np.zeros((2, 3), np.float32)
    p1, p2 = params_from_jax([(w1, a1, None), (w2, a2, w1)], device="cpu")
    assert isinstance(p1, tlayers.V1Params) and isinstance(p2, tlayers.V2Params)
    assert p2.skip is not None and p1.skip is None
    with pytest.raises(ValueError, match="neither"):
        params_from_jax([(w1, np.zeros((2, 4), np.float32), None)],
                        device="cpu")


def test_dense_layer_types_still_raise():
    """The dense types initialise since their port, with the JAX package's
    leaf shapes (so ``params_from_jax`` takes them unchanged: a GATv2
    layer's ``a`` has F_out columns, a GATv1 layer's 2 F_out) and xavier
    uniform W and a, within the bound."""
    for lt, cls in (("GAT", tlayers.V1Params), ("GATv2", tlayers.V2Params)):
        cfg = tgat.GATConfig(nlayers=1, nheads=(16,), nfeats=(64, 32),
                             dropout=0.0, alpha=0.2, layer_type=lt)
        (p,) = tgat.init_gat(cfg, make_generator("cpu", 0), device="cpu")
        (jp,) = jax.eval_shape(
            lambda k: jgat.init_gat(k, jgat.GATConfig(*cfg)),
            jax.random.PRNGKey(0))
        assert p.W.shape == jp.W.shape and p.a.shape == jp.a.shape
        (q,) = params_from_jax([tuple(t.detach().numpy() for t in p[:2])
                                + (None,)], device="cpu")
        assert isinstance(q, cls) and torch.equal(q.W, p.W)
        fan = 2 * 64 + 32 if lt == "GATv2" else 64 + 32
        assert float(p.W.detach().abs().max()) <= 1.414 * np.sqrt(6.0 / fan)


def test_v2_graph_without_stream_layout_names_the_roadmap():
    """A graph without a stream layout (N_pad not a multiple of 128) takes
    the unfused branch, which matches the JAX package's, forward and
    gradients (it raised before the unfused branch was ported)."""
    rng = np.random.default_rng(2)
    n = 60
    s = np.concatenate([rng.integers(0, n, 300), np.arange(n)])
    r = np.concatenate([rng.integers(0, n, 300), np.arange(n)])
    gj = jbuild_graph(s, r, None, n, node_align=8)
    g = tbuild_graph(s, r, None, n, node_align=8, device="cpu")
    assert g.r_local is None
    w = (rng.standard_normal((2, 8, 3)) * 0.5).astype(np.float32)
    a = (rng.standard_normal((2, 3)) * 0.5).astype(np.float32)
    x = rng.standard_normal((g.num_nodes_padded, 4)).astype(np.float32)

    def jloss(p, h):
        out = jlayers.gat_v2_sparse_heads(
            jlayers.V2Params(*p, None), h, gj, None, alpha=0.2, drop=0.0,
            concat=True, train=False)
        return jnp.sum(jnp.sin(out)), out

    (_, out_j), grads_j = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))((jnp.asarray(w), jnp.asarray(a)),
                                              jnp.asarray(x))
    tw, ta, th = (torch.tensor(t, requires_grad=True) for t in (w, a, x))
    out = tlayers.gat_v2_sparse_heads(
        tlayers.V2Params(tw, ta, None), th, g, None, alpha=0.2, drop=0.0,
        concat=True, train=False)
    torch.sin(out).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               rtol=1e-5, atol=1e-6)
    for got, want in zip((tw, ta, th), (*grads_j[0], grads_j[1])):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-5)


def test_v2_sign_split_bound_tops_every_logit(setup, monkeypatch):
    """The layer hands the fused op ``ub >= logit`` for every live edge (so
    no numerator exceeds 1), and the bound is reached where the extreme
    sender is the neighbour; the softmax itself is invariant to it."""
    _, gt, x, _ = setup
    seen = {}
    real = tlayers.fused_v2_attention

    def spy(whi, whj, ub, a, *rest):
        seen.update(whi=whi.detach(), whj=whj.detach(), ub=ub, a=a.detach())
        return real(whi, whj, ub, a, *rest)

    monkeypatch.setattr(tlayers, "fused_v2_attention", spy)
    gen = make_generator("cpu", 4)
    h, f_in, f_out = 3, 24, 5
    params = tlayers.V2Params(torch.randn(h, 2 * f_in, f_out, generator=gen),
                              torch.randn(h, f_out, generator=gen), None)
    tlayers.gat_v2_sparse_heads(params, torch.from_numpy(x), gt, None,
                                alpha=0.2, drop=0.0, concat=True, train=False)
    assert not seen["ub"].requires_grad
    live = gt.r_local < 128
    rcv, snd = gt.receivers.long()[live], gt.senders.long()[live]
    pre = seen["whi"][rcv] + seen["whj"][snd]
    pre = torch.where(pre >= 0, pre, 0.2 * pre).view(-1, h, f_out)
    logits = (pre * seen["a"]).sum(-1)
    slack = seen["ub"][rcv] - logits
    assert float(slack.min()) >= -1e-4
    # not vacuous: the bound is within the spread of whj of the logits
    assert float(slack.min()) < 5.0
