"""The PyTorch port's GAT_sparse model and train step against the JAX
package, with the same parameters (carried by ``params_from_jax``) and
dropout off: model output and parameter gradients through the fused path,
and a 5-step loss trajectory (the JAX train step on its CPU default, the
unfused scatter path)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from pygat_tpu.graph import build_graph as jbuild_graph
from pygat_tpu.models import gat as jgat
from pygat_tpu.ops import segment as jseg
from pygat_tpu.train import loop as jloop
from pygat_tpu.train import state as jstate
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from pygat_tpu_torch.graph import build_graph as tbuild_graph
from pygat_tpu_torch.models import gat as tgat
from pygat_tpu_torch.models.convert import params_from_jax
from pygat_tpu_torch.train import loop as tloop
from pygat_tpu_torch.train import state as tstate
from pygat_tpu_torch.utils.platform import make_generator


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(3)
    n = 300
    s = np.concatenate([rng.integers(0, n, n * 6), np.arange(n)])
    r = np.concatenate([rng.integers(0, n, n * 6), np.arange(n)])
    gj = jbuild_graph(s, r, None, n)
    gt = tbuild_graph(s, r, None, n, device="cpu")
    x = (rng.standard_normal((gj.num_nodes_padded, 32)) * 0.5).astype(np.float32)
    labels = np.full(gj.num_nodes_padded, -1, np.int32)
    labels[:n] = rng.integers(0, 4, n)
    return gj, gt, x, labels


def _cfg(skip: bool, dropout: float = 0.0):
    kw = dict(nlayers=2, nheads=(4, 2), nfeats=(32, 8, 4), dropout=dropout,
              alpha=0.2, layer_type="GAT_sparse", skip_connection=skip)
    return jgat.GATConfig(**kw), tgat.GATConfig(**kw)


def _numpy_params(jparams):
    return [tuple(None if t is None else np.asarray(t) for t in p)
            for p in jparams]


@pytest.mark.parametrize("skip", [False, True])
def test_apply_gat_matches_jax_fused(setup, skip):
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
    out_t = tgat.apply_gat(tparams, cfg_t, torch.from_numpy(x), gt, None,
                           train=False)
    torch.sin(out_t).sum().backward()

    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               atol=2e-4, rtol=1e-4)
    gj_flat = np.asarray(ravel_pytree(grads_j)[0])
    gt_flat = torch.cat([p.grad.reshape(-1)
                         for p in tgat.parameters(tparams)]).numpy()
    scale = float(np.abs(gj_flat).max())
    np.testing.assert_allclose(gt_flat, gj_flat, atol=5e-5 * scale)


def test_five_step_loss_trajectory_matches_jax(setup):
    """Five Adam steps (L2 in the gradient) with dropout off: the same loss
    at every step as the JAX train step from the same parameters."""
    gj, gt, x, labels = setup
    cfg_j, cfg_t = _cfg(False)
    lr, wd = 0.01, 5e-4
    idx = np.arange(0, 200, dtype=np.int32)
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
    tstep, teval = tloop.make_transductive_steps(cfg_t)
    losses_t = []
    for _ in range(5):
        ts, loss, _, _ = tstep(ts, torch.from_numpy(x), gt,
                               torch.from_numpy(labels), torch.from_numpy(idx))
        losses_t.append(float(loss))
    assert ts.step == 5
    assert losses_t[-1] < losses_t[0]
    np.testing.assert_allclose(losses_t, losses_j, rtol=2e-5)
    # and the parameters after five updates
    flat_j = np.asarray(ravel_pytree(js.params)[0])
    flat_t = torch.cat([p.detach().reshape(-1)
                        for p in tgat.parameters(ts.params)]).numpy()
    np.testing.assert_allclose(flat_t, flat_j, atol=1e-5)
    loss_e, _, _ = teval(ts.params, torch.from_numpy(x), gt,
                         torch.from_numpy(labels), torch.from_numpy(idx))
    assert torch.isfinite(loss_e)


def test_dropout_train_step_is_finite_and_seeded(setup):
    """With dropout, two steps from the same generator seed agree exactly
    and differ from another seed; losses are finite."""
    _, gt, x, labels = setup
    _, cfg_t = _cfg(False, dropout=0.6)
    idx = torch.arange(200, dtype=torch.int32)

    def run(seed):
        params = tgat.init_gat(cfg_t, make_generator("cpu", 0),
                                device="cpu")
        st = tstate.init_state(params, tstate.make_optimizer(params, 0.01, 0.0),
                               make_generator("cpu", seed))
        step, _ = tloop.make_transductive_steps(cfg_t)
        return [float(step(st, torch.from_numpy(x), gt,
                           torch.from_numpy(labels), idx)[1])
                for _ in range(2)]

    a, b, c = run(5), run(5), run(6)
    assert all(np.isfinite(a))
    assert a == b and a != c


def test_unported_layer_types_raise():
    """Every layer type initialises now (the dense ones since their port):
    the dense types' W and a are xavier uniform (inside the bound, which
    xavier normal of the same std passes), at the JAX package's shapes;
    an unknown type still raises."""
    for lt in ("GAT", "GATv2"):
        kw = dict(nlayers=2, nheads=(8, 2), nfeats=(64, 16, 4), dropout=0.0,
                  alpha=0.2, layer_type=lt, skip_connection=True)
        params = tgat.init_gat(tgat.GATConfig(**kw),
                               make_generator("cpu", 0), device="cpu")
        want = jax.eval_shape(
            lambda k: jgat.init_gat(k, jgat.GATConfig(**kw)),
            jax.random.PRNGKey(0))
        for p, jp in zip(params, want):
            f_in, f_out = jp.skip.shape[1:]
            fans = ((2 * f_in + f_out, f_out + 1) if lt == "GATv2"
                    else (f_in + f_out, 2 * f_out + 1))
            for t, jt, fan in zip(p[:2], jp[:2], fans):
                assert t.shape == jt.shape and t.requires_grad
                bound = 1.414 * np.sqrt(6.0 / fan)
                assert bound * 0.9 < float(t.detach().abs().max()) <= bound
    bad = tgat.GATConfig(nlayers=1, nheads=(1,), nfeats=(4, 2), dropout=0.0,
                         alpha=0.2, layer_type="GAT_dense")
    with pytest.raises(ValueError, match="unknown layer_type"):
        tgat.init_gat(bad, make_generator("cpu", 0), device="cpu")
