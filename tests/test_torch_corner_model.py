"""The PyTorch port's models and trainers over the corner plans:
``apply_gat`` with corner plans against the JAX package's ``apply_gat(plans=
...)`` (dropout off, forward and parameter gradients, the same parameters
through ``params_from_jax``), a 5-step dropout-0 loss trajectory against
the JAX train step, the corner path against the receiver stream in the
port under dropout with the same generator (the same masks), both trainers
planning by themselves under ``set_corner("on")``, and ``--corner on``
through the CLI."""

from __future__ import annotations

import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from pygat_tpu.graph import build_graph as jbuild_graph
from pygat_tpu.models import gat as jgat
from pygat_tpu.ops import segment as jseg
from pygat_tpu.ops.large import plan_csc_to_csr as jplan_csc_to_csr
from pygat_tpu.train import loop as jloop
from pygat_tpu.train import state as jstate
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from pygat_tpu_torch.data.synthetic import clustered_citation
from pygat_tpu_torch.graph import build_graph as tbuild_graph
from pygat_tpu_torch.models import gat as tgat
from pygat_tpu_torch.models import layers as tlayers
from pygat_tpu_torch.models.convert import params_from_jax
from pygat_tpu_torch.ops import banded as tbd
from pygat_tpu_torch.ops import large as tlarge
from pygat_tpu_torch.train import loop as tloop
from pygat_tpu_torch.train import state as tstate
from pygat_tpu_torch.train.logging import TrainLogger
from pygat_tpu_torch.utils.platform import make_generator

LAYER_TYPES = ("GAT_sparse", "GATv2_sparse")


@pytest.fixture(scope="module")
def setup():
    """A uniform graph of 200 nodes, its corner plans (one pass: the
    interpret-mode JAX model is slow to compile; the multi-pass plans with
    overflow rows are held against JAX op by op in
    tests/test_torch_corner.py) in both packages, features and labels."""
    rng = np.random.default_rng(6)
    n = 200
    s = np.concatenate([rng.integers(0, n, n * 4), np.arange(n)])
    r = np.concatenate([rng.integers(0, n, n * 4), np.arange(n)])
    gj = jbuild_graph(s, r, None, n)
    gt = tbuild_graph(s, r, None, n, device="cpu")
    pj, pt = jplan_csc_to_csr(gj), tlarge.plan_csc_to_csr(gt)
    x = (rng.standard_normal((gj.num_nodes_padded, 32)) * 0.5).astype(np.float32)
    labels = np.full(gj.num_nodes_padded, -1, np.int32)
    labels[:n] = rng.integers(0, 4, n)
    return gj, gt, pj, pt, x, labels


def _cfg(layer_type, skip, dropout=0.0):
    kw = dict(nlayers=2, nheads=(4, 2), nfeats=(32, 8, 4), dropout=dropout,
              alpha=0.2, layer_type=layer_type, skip_connection=skip)
    return jgat.GATConfig(**kw), tgat.GATConfig(**kw)


def _numpy_params(jparams):
    return [tuple(None if t is None else np.asarray(t) for t in p)
            for p in jparams]


@pytest.mark.parametrize("layer_type", LAYER_TYPES)
def test_apply_gat_with_corner_plans_matches_jax(setup, layer_type):
    """Forward and parameter gradients of sum(sin(out)) with dropout off;
    the JAX side runs its corner Pallas kernels in interpret mode at
    'high' precision."""
    gj, gt, pj, pt, x, _ = setup
    cfg_j, cfg_t = _cfg(layer_type, skip=True)
    jparams = jgat.init_gat(jax.random.PRNGKey(0), cfg_j)

    @jax.jit  # interpret mode op by op costs several times the compile
    def value_and_grad(p):
        def loss(p_):
            with jseg.use_impl("stream"):
                out = jgat.apply_gat(p_, cfg_j, jnp.asarray(x), gj,
                                     jax.random.PRNGKey(1), train=False,
                                     plans=pj)
            return jnp.sum(jnp.sin(out)), out

        (_, out), grads = jax.value_and_grad(loss, has_aux=True)(p)
        return out, ravel_pytree(grads)[0]

    prev = jseg._STREAM_PRECISION
    jseg._STREAM_PRECISION = "high"
    try:
        out_j, grads_j = value_and_grad(jparams)
    finally:
        jseg._STREAM_PRECISION = prev

    tparams = params_from_jax(_numpy_params(jparams), device="cpu")
    out_t = tgat.apply_gat(tparams, cfg_t, torch.from_numpy(x), gt, None,
                           train=False, plans=pt)
    torch.sin(out_t).sum().backward()
    # the tolerances of the stream path's model tests
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               atol=2e-4, rtol=1e-4)
    grads_t = torch.cat([p.grad.reshape(-1)
                         for p in tgat.parameters(tparams)]).numpy()
    np.testing.assert_allclose(grads_t, np.asarray(grads_j), atol=2e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("layer_type", LAYER_TYPES)
def test_five_step_trajectory_with_corner_plans_matches_jax(setup, layer_type):
    """Five Adam steps with dropout off over the corner plans give the
    losses of the JAX train step (its CPU default, the unfused path: the
    same function by another route)."""
    gj, gt, _, pt, x, labels = setup
    cfg_j, cfg_t = _cfg(layer_type, skip=False)
    lr, wd = 0.01, 5e-4
    idx = np.arange(0, 100, dtype=np.int32)
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
    tstep, _ = tloop.make_transductive_steps(cfg_t, pt)
    losses_t = [float(tstep(ts, torch.from_numpy(x), gt,
                            torch.from_numpy(labels),
                            torch.from_numpy(idx))[1]) for _ in range(5)]
    assert losses_t[-1] < losses_t[0]
    np.testing.assert_allclose(losses_t, losses_j, rtol=2e-5)


@pytest.mark.parametrize("layer_type", LAYER_TYPES)
def test_corner_path_draws_the_stream_paths_masks(setup, layer_type):
    """Under dropout 0.6 with generators of one seed, the corner path and
    the receiver stream draw the same masks at the same sites, so the
    outputs and gradients agree (here exactly: the plain versions sum in
    the same order)."""
    _, gt, _, pt, x, _ = setup
    _, cfg = _cfg(layer_type, skip=True, dropout=0.6)
    results = []
    for plans in (pt, None):
        params = tgat.init_gat(cfg, make_generator("cpu", 0), device="cpu")
        out = tgat.apply_gat(params, cfg, torch.from_numpy(x), gt,
                             make_generator("cpu", 5), train=True,
                             plans=plans)
        torch.sin(out).sum().backward()
        results.append((out.detach(),
                        [p.grad for p in tgat.parameters(params)]))
    (out_c, grads_c), (out_s, grads_s) = results
    assert float(out_s.abs().max()) > 0.1
    torch.testing.assert_close(out_c, out_s, rtol=1e-6, atol=1e-6)
    for gc, gs in zip(grads_c, grads_s):
        torch.testing.assert_close(gc, gs, rtol=1e-5, atol=1e-6)


@pytest.fixture
def knobs(monkeypatch):
    """Restore the selection knobs after the test, whatever it sets."""
    monkeypatch.setattr(tbd, "_BAND_MODE", tbd._BAND_MODE)
    monkeypatch.setattr(tlarge, "_CORNER_MODE", tlarge._CORNER_MODE)
    return monkeypatch


def _spy(monkeypatch):
    """Count the layers' calls of the stream, banded and corner attention."""
    calls = {"stream": 0, "banded": 0, "corner": 0}
    for name in ("fused_v1_attention", "fused_v2_attention",
                 "fused_v1_attention_banded", "fused_v2_attention_banded",
                 "fused_v1_attention_corner", "fused_v2_attention_corner"):
        kind = name.rsplit("_", 1)[1]
        kind = "stream" if kind == "attention" else kind
        fn = getattr(tlayers, name)

        def counted(*args, _fn=fn, _kind=kind):
            calls[_kind] += 1
            return _fn(*args)

        monkeypatch.setattr(tlayers, name, counted)
    return calls


def test_trainers_pick_the_corner_plans_by_themselves(knobs):
    """Under set_corner("on") (and no band plan) both trainers plan, log
    the plans and run every layer over them; the fast loop selects the
    model of the per-epoch loop."""
    data = clustered_citation(300, 48, 3, "corner-fit", 60, device="cpu")
    tbd.set_band("off")
    tlarge.set_corner("on")
    calls = _spy(knobs)
    cfg = tgat.GATConfig(nlayers=2, nheads=(2, 1), nfeats=(48, 8, 3),
                         dropout=0.4, alpha=0.2, layer_type="GATv2_sparse")
    kw = dict(lr=0.01, weight_decay=5e-4, epochs=6, patience=100, seed=3,
              checkpoint_dir=None, log_every=100)
    text = io.StringIO()
    a = tloop.fit_transductive(cfg, data, logger=TrainLogger(stream=text),
                               **kw)
    # 2 layers x (train + eval forward) per epoch, and the test forward
    assert calls == {"stream": 0, "banded": 0, "corner": 2 * 2 * 6 + 2}
    b = tloop.fit_transductive_fast(cfg, data, epoch_chunk=3,
                                    logger=TrainLogger(stream=text), **kw)
    assert calls["corner"] == 2 * (2 * 2 * 6 + 2) and calls["stream"] == 0
    assert text.getvalue().count("corner_plan: rows=") == 2
    np.testing.assert_allclose(b.history, a.history, rtol=1e-5)
    assert b.best_epoch == a.best_epoch and np.isfinite(b.test_loss)


def test_train_cli_runs_the_corner_path(knobs, tmp_path):
    from pygat_tpu_torch.cli.train import main

    calls = _spy(knobs)
    out = io.StringIO()
    with redirect_stdout(out):
        rc = main(["--dataset", "cora", "--model", "GAT_sparse", "--corner",
                   "on", "--epochs", "2", "--no-cuda", "--no-checkpoint"])
    assert rc == 0 and tlarge._CORNER_MODE == "on"
    text = out.getvalue()
    assert "corner_plan: rows=" in text and "Epoch: 0002 loss_train:" in text
    assert calls == {"stream": 0, "banded": 0, "corner": 2 * 2 * 2 + 2}
