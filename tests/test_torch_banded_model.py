"""The PyTorch port's models and trainers over a band plan: ``apply_gat``
with a plan against the JAX package's ``apply_gat(plans=...)`` (eval mode,
the same parameters through ``params_from_jax``), a 3-step dropout-0 loss
trajectory with a plan against the JAX train step, and both trainers
picking the plan by themselves past the threshold (``set_band("auto",
n=...)``)."""

from __future__ import annotations

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygat_tpu.graph import build_graph as jbuild_graph
from pygat_tpu.models import gat as jgat
from pygat_tpu.ops import banded as jbd
from pygat_tpu.ops import segment as jseg
from pygat_tpu.train import loop as jloop
from pygat_tpu.train import state as jstate
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from pygat_tpu_torch.data.synthetic import clustered_citation
from pygat_tpu_torch.graph import build_graph as tbuild_graph
from pygat_tpu_torch.models import gat as tgat
from pygat_tpu_torch.models import layers as tlayers
from pygat_tpu_torch.models.convert import params_from_jax
from pygat_tpu_torch.ops import banded as tbd
from pygat_tpu_torch.train import loop as tloop
from pygat_tpu_torch.train import state as tstate
from pygat_tpu_torch.train.logging import TrainLogger
from pygat_tpu_torch.utils.platform import make_generator

LAYER_TYPES = ("GAT_sparse", "GATv2_sparse")


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(6)
    n = 500
    base = np.repeat(np.arange(n, dtype=np.int64), 6)
    s = np.clip(base + rng.integers(-180, 180, base.shape[0]), 0, n - 1)
    s = np.concatenate([s, np.arange(n)])
    r = np.concatenate([base, np.arange(n)])
    gj = jbuild_graph(s, r, None, n)
    gt = tbuild_graph(s, r, None, n, device="cpu")
    x = (rng.standard_normal((gj.num_nodes_padded, 32)) * 0.5).astype(np.float32)
    labels = np.full(gj.num_nodes_padded, -1, np.int32)
    labels[:n] = rng.integers(0, 4, n)
    return gj, gt, jbd.build_band_plan(gj, w=2), tbd.build_band_plan(gt, w=2), x, labels


def _cfg(layer_type, skip, dropout=0.0):
    kw = dict(nlayers=2, nheads=(4, 2), nfeats=(32, 8, 4), dropout=dropout,
              alpha=0.2, layer_type=layer_type, skip_connection=skip)
    return jgat.GATConfig(**kw), tgat.GATConfig(**kw)


def _numpy_params(jparams):
    return [tuple(None if t is None else np.asarray(t) for t in p)
            for p in jparams]


@pytest.mark.parametrize("layer_type", LAYER_TYPES)
def test_apply_gat_with_a_plan_matches_jax(setup, layer_type):
    """Eval-mode forward through both layers' banded ops; the JAX side runs
    its banded Pallas kernels in interpret mode at 'high' precision."""
    gj, gt, pj, pt, x, _ = setup
    cfg_j, cfg_t = _cfg(layer_type, skip=True, dropout=0.6)
    jparams = jgat.init_gat(jax.random.PRNGKey(0), cfg_j)

    @jax.jit  # interpret mode op by op costs several times the compile
    def forward(p):
        with jseg.use_impl("stream"):
            return jgat.apply_gat(p, cfg_j, jnp.asarray(x), gj,
                                  jax.random.PRNGKey(1), train=False,
                                  plans=pj)

    prev = jseg._STREAM_PRECISION
    jseg._STREAM_PRECISION = "high"
    try:
        out_j = forward(jparams)
    finally:
        jseg._STREAM_PRECISION = prev

    tparams = params_from_jax(_numpy_params(jparams), device="cpu")
    with torch.no_grad():
        out_t = tgat.apply_gat(tparams, cfg_t, torch.from_numpy(x), gt, None,
                               train=False, plans=pt)
    # tolerances of the stream path's model tests (tests/test_torch_model.py)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=2e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("layer_type", LAYER_TYPES)
def test_three_step_trajectory_with_a_plan_matches_jax(setup, layer_type):
    """Three Adam steps with dropout off over the banded order give the
    losses and parameters of the JAX train step (its CPU default, the
    unfused path: the same function in another edge order)."""
    gj, gt, _, pt, x, labels = setup
    cfg_j, cfg_t = _cfg(layer_type, skip=False)
    lr, wd = 0.01, 5e-4
    idx = np.arange(0, 200, dtype=np.int32)
    jparams = jgat.init_gat(jax.random.PRNGKey(0), cfg_j)

    tx = jstate.make_optimizer(lr, wd)
    js = jstate.init_state(jparams, tx, jax.random.PRNGKey(1))
    jstep, _ = jloop.make_transductive_steps(cfg_j, tx)
    losses_j = []
    for _ in range(3):
        js, loss, _, _ = jstep(js, jnp.asarray(x), gj, jnp.asarray(labels),
                               jnp.asarray(idx))
        losses_j.append(float(loss))

    tparams = params_from_jax(_numpy_params(jparams), device="cpu")
    ts = tstate.init_state(tparams, tstate.make_optimizer(tparams, lr, wd),
                           make_generator("cpu", 1))
    tstep, _ = tloop.make_transductive_steps(cfg_t, pt)
    losses_t = [float(tstep(ts, torch.from_numpy(x), gt,
                            torch.from_numpy(labels),
                            torch.from_numpy(idx))[1]) for _ in range(3)]
    assert losses_t[-1] < losses_t[0]
    # the tolerances of the stream path's trajectory test
    np.testing.assert_allclose(losses_t, losses_j, rtol=2e-5)
    flat_j = np.concatenate([np.asarray(t).ravel() for p in js.params
                             for t in p if t is not None])
    flat_t = torch.cat([p.detach().reshape(-1)
                        for p in tgat.parameters(ts.params)]).numpy()
    np.testing.assert_allclose(flat_t, flat_j, atol=1e-5)


@pytest.fixture
def band_knobs(monkeypatch):
    """Restore the band knobs after the test, whatever it sets."""
    for name in ("_BAND_MODE", "_BAND_N", "_BAND_W"):
        monkeypatch.setattr(tbd, name, getattr(tbd, name))
    return monkeypatch


@pytest.fixture(scope="module")
def clustered():
    return clustered_citation(300, 48, 3, "banded-fit", 60, device="cpu")


def _spy(monkeypatch):
    """Count the layers' calls of the stream and the banded attention."""
    calls = {"stream": 0, "banded": 0}
    for name, kind in (("fused_v1_attention", "stream"),
                       ("fused_v2_attention", "stream"),
                       ("fused_v1_attention_banded", "banded"),
                       ("fused_v2_attention_banded", "banded")):
        fn = getattr(tlayers, name)

        def counted(*args, _fn=fn, _kind=kind):
            calls[_kind] += 1
            return _fn(*args)

        monkeypatch.setattr(tlayers, name, counted)
    return calls


def test_trainers_pick_the_plan_by_themselves(band_knobs, clustered):
    """Under set_band("auto", n=N_pad) both trainers plan, log the plan and
    run every layer over the banded order (and select the same model: the
    keep masks are drawn over the banded slots in the same order)."""
    tbd.set_band("auto", n=clustered.graph.num_nodes_padded, w=1)
    calls = _spy(band_knobs)
    cfg = tgat.GATConfig(nlayers=2, nheads=(2, 1), nfeats=(48, 8, 3),
                         dropout=0.4, alpha=0.2, layer_type="GAT_sparse")
    kw = dict(lr=0.01, weight_decay=5e-4, epochs=6, patience=100, seed=3,
              checkpoint_dir=None, log_every=100)
    text = io.StringIO()
    a = tloop.fit_transductive(cfg, clustered, logger=TrainLogger(stream=text),
                               **kw)
    # 2 layers x (train + eval forward) per epoch, and the test forward
    assert calls == {"stream": 0, "banded": 2 * 2 * 6 + 2}
    b = tloop.fit_transductive_fast(cfg, clustered, epoch_chunk=3,
                                    logger=TrainLogger(stream=text), **kw)
    assert calls == {"stream": 0, "banded": 2 * (2 * 2 * 6 + 2)}
    assert text.getvalue().count("band_plan: w=1") == 2
    np.testing.assert_allclose(b.history, a.history, rtol=1e-5)
    assert b.best_epoch == a.best_epoch and np.isfinite(b.test_loss)


def test_trainers_keep_the_stream_below_the_threshold(band_knobs, clustered):
    tbd.set_band("auto", n=clustered.graph.num_nodes_padded + 1)
    calls = _spy(band_knobs)
    cfg = tgat.GATConfig(nlayers=2, nheads=(2, 1), nfeats=(48, 8, 3),
                         dropout=0.4, alpha=0.2, layer_type="GATv2_sparse")
    text = io.StringIO()
    tloop.fit_transductive_fast(cfg, clustered, lr=0.01, weight_decay=5e-4,
                                epochs=2, patience=100, epoch_chunk=2,
                                checkpoint_dir=None,
                                logger=TrainLogger(stream=text))
    assert calls == {"stream": 2 * 2 * 2 + 2, "banded": 0}
    assert "band_plan" not in text.getvalue()
