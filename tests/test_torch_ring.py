"""The port's multi-GPU path on the CPU, under gloo groups of 2 and 4
processes (one spawn a group size, ``tests/torch_dist.py``), against the
JAX package on one device.

* The ring (``parallel.ring_model`` over ``parallel.partition``): each
  rank's rows of the forward, the loss, the all-reduced gradients and the
  first Adam step against the JAX single-device ``apply_gat`` and
  ``make_transductive_steps`` on the same interleaved data, for GATv1 and
  GATv2, rotation and halo, fused and unfused hops, dropout off, to 1e-5
  of each quantity's largest value (two f32 computations summing in other
  orders); the parameters equal bit for bit on every rank after 3 steps.
* The CLI, ``cli.train --no-cuda --mesh D,1 --partition ring``: both
  sparse models, rotation and halo, both loops.
* The banked PPI loop under a mesh: one data-parallel super-step against
  the JAX package's (``superbatch`` semantics: the weighted mean over the
  slots, pad slots at weight 0) and against the port's ``dp=D`` run in one
  process.
* The stacked PPI loop under the group of 2, ``fit_inductive_fast(mesh=)``,
  against the JAX package's at ``make_mesh(2, 1)``
  (``make_sharded_inductive_epochs``).
* The model axis: the same groups as meshes ``(1, 2)`` and ``(2, 2)``,
  heads split over the model group. Every layer type (the sparse ones over
  the ring, rotation and halo; the dense ones by receiver rows) on a
  3-layer model whose layers are split, whole and split (2, 1 and 2
  heads: ``gather_heads``, a replicated layer, ``sum_heads``): forward,
  loss, whole gradients and the first Adam step against the JAX package on
  one device, to 1e-5 of each quantity's largest value; replicated leaves
  bit-equal across each model group, split leaves across each data group;
  a checkpoint written under the mesh restores whole on one device and as
  each rank's share. The CLI at ``--mesh 1,2`` / ``2,2``; the banked PPI
  loop at either mesh (PPI's two split layers: a split layer fed by a split
  one) against the one-process loop and, at ``(2, 2)``, the JAX
  super-step; the stacked loop at ``(1, 2)`` against the JAX package's at
  ``make_mesh(1, 2)``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pygat_tpu.data import ppi as jppi
from pygat_tpu.graph import build_graph as jbuild_graph
from pygat_tpu.models.gat import GATConfig as JConfig
from pygat_tpu.models.gat import apply_gat as japply_gat
from pygat_tpu.models.gat import init_gat as jinit_gat
from pygat_tpu.train.metrics import bce_with_logits as jbce
from pygat_tpu.train.metrics import log_logits as jlog_logits
from pygat_tpu.train.metrics import nll_loss as jnll_loss
from pygat_tpu.train.state import make_optimizer as jmake_optimizer
from tests.torch_dist import GroupRun, _params, group_work
from tests.torch_ppi_data import CFG as PPI_CFG
from tests.torch_ppi_data import synth_ppi
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from pygat_tpu_torch.data import ppi as tppi
from pygat_tpu_torch.models.gat import GATConfig
from pygat_tpu_torch.train.inductive import fit_inductive_banked, _batch_slots
from pygat_tpu_torch.train.logging import TrainLogger

CFG = dict(nlayers=2, nheads=(2, 1), nfeats=(16, 8, 3), dropout=0.0,
           alpha=0.2)
N, N_PAD, N_RING = 300, 384, 512  # N_RING: the repad for 2 and 4 shards
LR, WD = 0.005, 5e-4
LAYER_TYPES = ("GAT_sparse", "GATv2_sparse")
CASES = [(lt, halo, fused) for lt in LAYER_TYPES for halo in (False, True)
         for fused in (True, False)]
STEPS = 3
# the CLI runs of the two groups: both models, rotation and halo, both
# loops, and both --partition values
RUNS = {2: [(["--model", "GAT_sparse", "--mesh", "2,1", "--partition",
              "ring", "--epochs", "2"], {"PYGAT_RING_HALO": "0"})],
        4: [(["--model", "GATv2_sparse", "--mesh", "4,1", "--epochs", "2",
              "--epoch-chunk", "2"], {"PYGAT_RING_HALO": "1"})]}
PPI_KW = dict(batch_size=2, lr=0.01, weight_decay=5e-4, seed=3, epochs=1,
              epoch_chunk=1, patience=5, device="cpu")
# the PPI model cut to two layers, skip connections kept
PPI_CFG = dict(PPI_CFG, nlayers=2, nheads=(2, 2), nfeats=(128, 8, 6))
# the stacked loop under the group of 2: 3 epochs of one super-step each
FAST_KW = dict(batch_size=2, lr=0.01, weight_decay=5e-4, seed=3, epochs=3,
               patience=5)
# the model axis: layers of 2, 1 and 2 heads (split, replicated, split at
# M = 2), skip connections; every layer type, the sparse ones by rotation
# and halo
MCFG = dict(nlayers=3, nheads=(2, 1, 2), nfeats=(16, 8, 8, 3), dropout=0.0,
            alpha=0.2, skip_connection=True)
MODEL_TYPES = ("GAT_sparse", "GATv2_sparse", "GAT", "GATv2")
MODEL_CASES = [(lt, halo) for lt in MODEL_TYPES[:2] for halo in (False, True)
               ] + [(lt, None) for lt in MODEL_TYPES[2:]]
MODEL_RUNS = {2: [(["--model", "GAT_sparse", "--mesh", "1,2", "--epochs",
                    "2"], {"PYGAT_RING_HALO": "0"})],
              4: [(["--model", "GATv2_sparse", "--mesh", "2,2", "--epochs",
                    "2", "--epoch-chunk", "2"], {"PYGAT_RING_HALO": "1"})]}


def _shapes(cfg):
    """The JAX model's parameter structure (layer types and leaf shapes),
    traced only."""
    return jax.eval_shape(lambda: jinit_gat(jax.random.PRNGKey(0), cfg))


def _drawn_params(cfg, rng):
    """Numpy parameters of the JAX model ``cfg`` (its leaf shapes), uniform
    on the xavier bound of each leaf's last two axes."""
    return [tuple(None if t is None else (rng.uniform(-1, 1, t.shape)
                                          * np.sqrt(6 / sum(t.shape[-2:]))
                                          ).astype(np.float32)
                  for t in layer) for layer in _shapes(cfg)]


def _numpy_params(params):
    return [tuple(None if t is None else np.asarray(t) for t in layer)
            for layer in params]


@pytest.fixture(scope="module")
def spec():
    rng = np.random.default_rng(14)
    s = np.concatenate([rng.integers(0, N, N * 5), np.arange(N)])
    r = np.concatenate([rng.integers(0, N, N * 5), np.arange(N)])
    x = np.zeros((N_PAD, CFG["nfeats"][0]), np.float32)
    x[:N] = rng.random((N, CFG["nfeats"][0]), dtype=np.float32)
    labels = np.full(N_PAD, -1, np.int32)
    labels[:N] = rng.integers(0, 3, N)
    params = {lt: _numpy_params(jinit_gat(jax.random.PRNGKey(i),
                                          JConfig(layer_type=lt, **CFG)))
              for i, lt in enumerate(LAYER_TYPES)}
    ppi_params = _numpy_params(jinit_gat(
        jax.random.PRNGKey(7), JConfig(layer_type="GAT_sparse", **PPI_CFG)))
    mparams = {lt: _drawn_params(JConfig(layer_type=lt, **MCFG), rng)
               for lt in MODEL_TYPES}
    return dict(
        ring=dict(send=s, recv=r, n=N, n_pad=N_PAD, x=x, labels=labels,
                  idx_train=np.arange(0, 90, dtype=np.int32),
                  idx_val=np.arange(90, 180, dtype=np.int32),
                  idx_test=np.arange(180, N, dtype=np.int32), n_classes=3,
                  cfg=CFG, params=params, lr=LR, wd=WD, mcfg=MCFG,
                  mparams=mparams),
        ppi=dict(cfg=dict(layer_type="GAT_sparse", **PPI_CFG),
                 params=ppi_params, kw=PPI_KW, fast_kw=FAST_KW))


@pytest.fixture(scope="module")
def groups(spec, tmp_path_factory):
    """The 2- and 4-rank groups, started together before the JAX
    references are computed, and waited for by the first test that reads
    them."""
    runs = {}
    for d in (2, 4):
        tmp = tmp_path_factory.mktemp(f"group{d}")
        runs[d] = GroupRun(group_work, d, tmp, spec["ring"], CASES, STEPS,
                           RUNS[d], spec["ppi"], tmp, MODEL_CASES,
                           MODEL_RUNS[d], timeout=180)
    return runs


@pytest.fixture(scope="module", params=[2, 4], ids=["d2", "d4"])
def group(request, groups, jax_ref, jax_superstep, jax_fast_mesh,
          jax_model_ref, jax_fast_model_mesh):
    # the JAX references are computed while the ranks run
    return request.param, groups[request.param].results()


@pytest.fixture(scope="module")
def jax_ref(spec):
    """The JAX package on one device: per layer type the output, the loss
    and gradients over the train split and the parameters after one Adam
    step, on the graph as loaded (padded to the ring's N_RING rows), and
    for each group size the interleave's node map, by which the ring's
    rows are compared (the model is node-permutation-equivariant)."""
    rs = spec["ring"]
    g, x, labels, idx = _ring_inputs(rs)
    ref = {}
    for d in (2, 4):
        # jcit.interleave_citation's map: node v to row (v % d) * n_local
        # + v // d
        v = np.arange(N)
        ref[d] = (v % d) * (N_RING // d) + v // d
    for lt in LAYER_TYPES:
        ref[lt] = _jax_single(JConfig(layer_type=lt, **CFG),
                              rs["params"][lt], g, x, labels, idx)
    return ref


def _jax_single(cfg, arrays, g, x, labels, idx):
    """The JAX model ``cfg`` on one device from the parameters ``arrays``:
    its output's real rows, the NLL over ``idx``, the gradients and the
    parameters after one Adam step."""
    params = [type(layer)(*(None if a is None else jnp.asarray(a)
                            for a in layer_arrays))
              for layer, layer_arrays in zip(
                  _shapes(cfg), arrays)]

    def loss_fn(p):
        out = japply_gat(p, cfg, jnp.asarray(x), g, jax.random.PRNGKey(0),
                         train=False)
        lp = jlog_logits(out)
        return jnll_loss(lp[idx], jnp.asarray(labels)[idx]), out

    tx = jmake_optimizer(LR, WD)

    @jax.jit  # the step and the update in one compile
    def step(p):
        (loss, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        return loss, out, grads, optax.apply_updates(p, updates)

    loss, out, grads, new = step(params)
    return dict(
        loss=float(loss), out=np.asarray(out)[:N],
        grads=[np.asarray(t) for layer in grads for t in layer
               if t is not None],
        params1=[np.asarray(t) for layer in new for t in layer
                 if t is not None])


def _ring_inputs(rs):
    """The graph, features, labels and train split as loaded, padded to
    the ring's N_RING rows."""
    g = jbuild_graph(rs["send"], rs["recv"], None, N, n_pad=N_RING)
    x = np.zeros((N_RING, CFG["nfeats"][0]), np.float32)
    x[:N_PAD] = rs["x"]
    labels = np.full(N_RING, -1, np.int32)
    labels[:N_PAD] = rs["labels"]
    return g, x, labels, jnp.asarray(rs["idx_train"])


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale,
                               err_msg=what)


def _case_id(case):
    lt, halo, fused = case
    return (f"{'v2' if 'v2' in lt else 'v1'}-{'halo' if halo else 'rot'}-"
            f"{'fused' if fused else 'unfused'}")


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_ring_forward_and_loss_match_jax(group, jax_ref, case):
    d, ranks = group
    ref = jax_ref[case[0]]
    out = np.concatenate([r["ring"][case]["out"] for r in ranks])
    _close(out[jax_ref[d]], ref["out"], "out")
    for r in ranks:
        assert r["ring"][case]["loss"] == pytest.approx(ref["loss"], rel=1e-5)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_ring_gradients_and_adam_step_match_jax(group, jax_ref, case):
    _, ranks = group
    ref = jax_ref[case[0]]
    rec = ranks[0]["ring"][case]
    for i, (g, want) in enumerate(zip(rec["grads"], ref["grads"])):
        _close(g, want, f"grad {i}")
    for i, (p, want) in enumerate(zip(rec["params1"], ref["params1"])):
        _close(p, want, f"param {i} after one step")


def test_parameters_stay_equal_on_every_rank(group):
    """The all-reduced gradients give every rank the same update: the
    parameters are equal bit for bit in every case, after 3 steps in the
    fused halo cases (one step in the others)."""
    _, ranks = group
    for case in CASES:
        for r in ranks[1:]:
            for a, b in zip(r["ring"][case]["params_last"],
                            ranks[0]["ring"][case]["params_last"]):
                np.testing.assert_array_equal(a, b, err_msg=str(case))
    assert STEPS == 3  # (halo, fused) cases run all of them


def test_mesh_of_another_size_raises(group):
    """A mesh needs exactly its D * M ranks: one more than the group has
    raises on every rank."""
    d, ranks = group
    for r in ranks:
        assert r["wrong_size"] is not None
        assert f"needs {d + 1} ranks, the group has {d}" in r["wrong_size"]


def test_ranks_agree_on_a_capture_one_rank_refused(group):
    """The fast loop's capture verdict is the group's: a capture that held
    on every rank is kept everywhere; one that the last rank refused sends
    every rank eager, so none replays its NCCL calls while another issues
    them eagerly."""
    d, res = group
    for rank, r in enumerate(res):
        held, refused = r["capture"]
        assert held is None
        assert refused == ("RuntimeError: refused" if rank == d - 1
                           else "the capture failed on another rank")


def test_cli_trains_on_the_ring(group):
    """``cli.train --no-cuda --mesh D,1``: rank 0 logs every epoch (the
    other ranks write nothing), the training loss falls, the losses are
    finite."""
    d, ranks = group
    for recs, (argv, _) in zip(ranks[0]["cli"], RUNS[d]):
        ring = [r for r in recs if r["kind"] == "ring"]
        assert ring and ring[0]["shards"] == d, argv
        epochs = [r for r in recs if r["kind"] == "epoch"]
        assert len(epochs) == int(argv[argv.index("--epochs") + 1]), argv
        losses = [r["loss_train"] for r in epochs]
        assert all(np.isfinite(losses)) and losses[-1] < losses[0], argv
        assert [r for r in recs if r["kind"] == "test"], argv


@pytest.fixture(scope="module")
def jax_superstep(spec):
    """The JAX package's data-parallel super-step on the port's first
    shuffled batches: the weighted mean of the slots' losses, one Adam
    update. The pad slots of D = 4 weigh 0, so one super-step over the two
    live batches is the reference of both group sizes."""
    spec, d = spec["ppi"], 2
    kw = spec["kw"]
    cfg = JConfig(**spec["cfg"])
    data = synth_ppi(jppi.PPIGraph, jppi.PPIData)
    n_pg, e_pg = jppi.bank_bounds([data.train, data.valid, data.test])
    bank = jppi.build_bank(data.train, n_pg, e_pg)
    order = np.arange(len(data.train))
    np.random.default_rng(kw["seed"]).shuffle(order)
    slots = _batch_slots(len(data.train), kw["batch_size"], order)
    ids = np.arange(d) % len(slots)
    w = (np.arange(d) < len(slots)).astype(np.float32)
    params = [type(layer)(*(None if a is None else jnp.asarray(a)
                            for a in arrays))
              for layer, arrays in zip(_shapes(cfg),
                                       spec["params"])]

    def super_loss(p):
        total = 0.0
        for j in range(d):
            idx, live = slots[ids[j]]
            x, g, y = jppi.assemble_banked_batch(
                bank, jnp.asarray(idx, jnp.int32), jnp.asarray(live))
            out = japply_gat(p, cfg, x, g, jax.random.PRNGKey(0), train=True)
            total = total + w[j] * jbce(out, y, mask=g.node_mask)
        return total / max(w.sum(), 1.0)

    grads = jax.jit(jax.grad(super_loss))(params)
    tx = jmake_optimizer(kw["lr"], kw["weight_decay"])
    updates, _ = tx.update(grads, tx.init(params), params)
    new = optax.apply_updates(params, updates)
    return [np.asarray(t) for layer in new for t in layer if t is not None]


def test_banked_loop_under_a_mesh_matches_jax_and_dp(group, spec,
                                                    jax_superstep):
    """One epoch (one super-step of D slots: the 2 train batches, and at D
    = 4 two pad slots) under the mesh against the JAX package's super-step
    on the same batches, and its validation history against the port's
    ``dp=D`` run in one process."""
    d, ranks = group
    got = ranks[0]["ppi"]
    for r in ranks[1:]:
        for a, b in zip(r["ppi"]["params"], got["params"]):
            np.testing.assert_array_equal(a, b)
    for i, (p, q) in enumerate(zip(got["params"], jax_superstep)):
        _close(p, q, f"param {i}")
    cfg = GATConfig(**spec["ppi"]["cfg"])
    with open("/dev/null", "w") as quiet:
        local = fit_inductive_banked(
            cfg, synth_ppi(tppi.PPIGraph, tppi.PPIData), dp=d,
            init_params=_params(cfg, spec["ppi"]["params"]),
            logger=TrainLogger(stream=quiet), **PPI_KW)
    np.testing.assert_allclose(got["history"], local.history, rtol=1e-6)
    assert got["best_epoch"] == local.best_epoch
    with torch.no_grad():
        for p, q in zip(got["params"],
                        [t.numpy() for layer in local.state.params
                         for t in layer if t is not None]):
            np.testing.assert_allclose(p, q, rtol=0,
                                       atol=1e-6 * float(np.abs(q).max()))


@pytest.fixture(scope="module")
def jax_fast_mesh(spec):
    """The JAX package's ``fit_inductive_fast`` over ``make_mesh(2, 1)``
    (GSPMD's data-parallel super-steps) from the same parameters."""
    import os

    from pygat_tpu.parallel.mesh import make_mesh
    from pygat_tpu.train.logging import TrainLogger as JLogger
    from pygat_tpu.train.loop import fit_inductive_fast as jfit_fast

    ppi = spec["ppi"]
    cfg = JConfig(**ppi["cfg"])
    params = [type(layer)(*(None if a is None else jnp.asarray(a)
                            for a in arrays))
              for layer, arrays in zip(_shapes(cfg),
                                       ppi["params"])]
    with open(os.devnull, "w") as quiet:
        return jfit_fast(cfg, synth_ppi(jppi.PPIGraph, jppi.PPIData),
                         init_params=params, mesh=make_mesh(2, 1),
                         logger=JLogger(stream=quiet), **ppi["fast_kw"])


def test_fast_loop_under_a_mesh_matches_jax(groups, jax_fast_mesh):
    """``fit_inductive_fast(mesh=)`` on the group of 2 against the JAX
    package's at ``make_mesh(2, 1)``: the validation history within 2e-4,
    the same best epoch, the test loss and micro-F1; the parameters equal
    bit for bit on both ranks."""
    ranks = groups[2].results()
    got = ranks[0]["ppi_fast"]
    for a, b in zip(ranks[1]["ppi_fast"]["params"], got["params"]):
        np.testing.assert_array_equal(a, b)
    assert ranks[1]["ppi_fast"]["history"] == got["history"]
    ref = jax_fast_mesh
    assert len(got["history"]) == FAST_KW["epochs"]
    np.testing.assert_allclose(got["history"], ref.history, rtol=2e-4)
    assert got["best_epoch"] == ref.best_epoch
    np.testing.assert_allclose(got["test_loss"], ref.test_loss, rtol=2e-4)
    assert abs(got["test_acc"] - ref.test_acc) <= 2e-3


# ---------------------------------------------------------------------------
# The model axis: meshes (1, 2) and (2, 2) of the same groups
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_model_ref(spec):
    """The JAX package on one device, per layer type of the model axis's
    3-layer model, as :func:`jax_ref`."""
    rs = spec["ring"]
    g, x, labels, idx = _ring_inputs(rs)
    return {lt: _jax_single(JConfig(layer_type=lt, **MCFG), rs["mparams"][lt],
                            g, x, labels, idx) for lt in MODEL_TYPES}


def _model_case_id(case):
    lt, halo = case
    return lt if halo is None else f"{lt}-{'halo' if halo else 'rot'}"


def _zero_in_exact_arithmetic(lt, i):
    """The dense GATv2's ``a`` (leaf 1 of W, a, skip): its logit is per
    receiver (the reference's [N, 1] quirk), constant along its softmax
    row, so its gradient is rounding noise on either side."""
    return lt == "GATv2" and i % 3 == 1


@pytest.mark.parametrize("case", MODEL_CASES, ids=_model_case_id)
def test_model_axis_forward_and_loss_match_jax(group, jax_model_ref, case):
    """Each data rank's rows of the forward (the model ranks of a data
    index hold the same rows, bit for bit), and the loss, against the JAX
    model on one device."""
    d, ranks = group
    n_data = d // 2
    ref = jax_model_ref[case[0]]
    rows = [r["model"]["steps"][case]["out"] for r in ranks]
    for k in range(n_data):
        np.testing.assert_array_equal(rows[2 * k], rows[2 * k + 1])
    out = np.concatenate(rows[::2])
    v = np.arange(N)
    _close(out[(v % n_data) * (N_RING // n_data) + v // n_data], ref["out"],
           "out")
    for r in ranks:
        assert r["model"]["steps"][case]["loss"] == pytest.approx(
            ref["loss"], rel=1e-5)


@pytest.mark.parametrize("case", MODEL_CASES, ids=_model_case_id)
def test_model_axis_gradients_and_adam_step_match_jax(group, jax_model_ref,
                                                      case):
    """The whole gradients (split leaves gathered over the model group) and
    the whole parameters after one Adam step against the JAX package's,
    on every rank: a gradient counted M times, or a share missing, shows
    here. A gradient that is zero in exact arithmetic is held to 1e-5 of
    the model's largest."""
    _, ranks = group
    ref = jax_model_ref[case[0]]
    top = max(float(np.abs(g).max()) for g in ref["grads"])
    for r in ranks:
        rec = r["model"]["steps"][case]
        for i, (g, want) in enumerate(zip(rec["grads"], ref["grads"])):
            if _zero_in_exact_arithmetic(case[0], i):
                assert float(np.abs(g).max()) <= 1e-5 * top, f"grad {i}"
                continue
            _close(g, want, f"grad {i}")
        for i, (p, want) in enumerate(zip(rec["params1"], ref["params1"])):
            _close(p, want, f"param {i} after one step")


def test_model_axis_leaves_stay_equal(group):
    """After 3 steps of every case: the split leaves are split as
    ``head_leaf_spec`` splits them (layers 1 and 3, not the 1-head layer
    2); each rank holds 1/M of each split leaf; a replicated leaf is equal
    bit for bit on every rank, a split one on the ranks of one model
    index."""
    d, ranks = group
    for case in MODEL_CASES:
        recs = [r["model"]["steps"][case] for r in ranks]
        assert recs[0]["split"] == (True,) * 3 + (False,) * 3 + (True,) * 3
        whole = recs[0]["params1"]
        for r, rec in enumerate(recs):
            for i, (mine, flag) in enumerate(zip(rec["local_last"],
                                                 rec["split"])):
                assert mine.shape[0] == whole[i].shape[0] // (2 if flag
                                                              else 1)
                peer = recs[r % 2] if flag else recs[0]
                np.testing.assert_array_equal(
                    mine, peer["local_last"][i], err_msg=f"{case} leaf {i}")
    assert STEPS == 3


def test_model_axis_checkpoint_restores_whole_and_split(group):
    """A checkpoint written under the mesh (the heads gathered, rank 0
    writing) holds the whole state, which loads on one device; read back
    under the mesh, each rank's share equals what it held, bit for bit."""
    _, ranks = group
    for r in ranks:
        rec = r["model"]["steps"][MODEL_CASES[0]]
        for a, b in zip(rec["ckpt_whole"], rec["ckpt_whole_want"]):
            np.testing.assert_array_equal(a, b)
        assert rec["ckpt_mine"]


def test_cli_trains_on_a_model_axis(group):
    """``cli.train --no-cuda --mesh 1,2`` / ``--mesh 2,2``: rank 0 logs
    which leaves are split and every epoch; the training loss falls."""
    d, ranks = group
    for recs, (argv, _) in zip(ranks[0]["model"]["cli"], MODEL_RUNS[d]):
        ring = [r for r in recs if r["kind"] == "ring"]
        assert ring and ring[0]["shards"] == d // 2, argv
        axis = [r for r in recs if r["kind"] == "model_axis"]
        assert axis and axis[0]["split"] == ["W0", "a0"], argv
        assert axis[0]["replicated"] == ["W1", "a1"], argv
        epochs = [r for r in recs if r["kind"] == "epoch"]
        assert len(epochs) == int(argv[argv.index("--epochs") + 1]), argv
        losses = [r["loss_train"] for r in epochs]
        assert all(np.isfinite(losses)) and losses[-1] < losses[0], argv


def test_banked_loop_on_a_model_axis(group, spec, jax_superstep):
    """The banked loop at ``(1, 2)`` / ``(2, 2)`` (both PPI layers split)
    against the one-process loop over D slots, and at ``(2, 2)`` against
    the JAX super-step; the whole parameters agree on every rank."""
    d, ranks = group
    n_data = d // 2
    got = ranks[0]["model"]["ppi"]
    for r in ranks[1:]:
        for a, b in zip(r["model"]["ppi"]["params"], got["params"]):
            np.testing.assert_array_equal(a, b)
    if n_data == 2:
        for i, (p, q) in enumerate(zip(got["params"], jax_superstep)):
            _close(p, q, f"param {i}")
    cfg = GATConfig(**spec["ppi"]["cfg"])
    with open("/dev/null", "w") as quiet:
        local = fit_inductive_banked(
            cfg, synth_ppi(tppi.PPIGraph, tppi.PPIData), dp=n_data,
            init_params=_params(cfg, spec["ppi"]["params"]),
            logger=TrainLogger(stream=quiet), **PPI_KW)
    np.testing.assert_allclose(got["history"], local.history, rtol=1e-5)
    with torch.no_grad():
        for p, q in zip(got["params"],
                        [t.numpy() for layer in local.state.params
                         for t in layer if t is not None]):
            _close(p, q, "param")


@pytest.fixture(scope="module")
def jax_fast_model_mesh(spec):
    """The JAX package's ``fit_inductive_fast`` over ``make_mesh(1, 2)``
    (GSPMD splitting the heads) from the same parameters."""
    import os

    from pygat_tpu.parallel.mesh import make_mesh
    from pygat_tpu.train.logging import TrainLogger as JLogger
    from pygat_tpu.train.loop import fit_inductive_fast as jfit_fast

    ppi = spec["ppi"]
    cfg = JConfig(**ppi["cfg"])
    params = [type(layer)(*(None if a is None else jnp.asarray(a)
                            for a in arrays))
              for layer, arrays in zip(_shapes(cfg),
                                       ppi["params"])]
    with open(os.devnull, "w") as quiet:
        return jfit_fast(cfg, synth_ppi(jppi.PPIGraph, jppi.PPIData),
                         init_params=params, mesh=make_mesh(1, 2),
                         logger=JLogger(stream=quiet), **ppi["fast_kw"])


def test_fast_loop_on_a_model_axis_matches_jax(groups, jax_fast_model_mesh):
    """``fit_inductive_fast(mesh=)`` at ``(1, 2)`` against the JAX
    package's at ``make_mesh(1, 2)``: the validation history within 2e-4,
    the best epoch, the test loss and micro-F1; the whole parameters equal
    bit for bit on both ranks."""
    ranks = groups[2].results()
    got = ranks[0]["model"]["ppi_fast"]
    for a, b in zip(ranks[1]["model"]["ppi_fast"]["params"], got["params"]):
        np.testing.assert_array_equal(a, b)
    ref = jax_fast_model_mesh
    assert len(got["history"]) == FAST_KW["epochs"]
    np.testing.assert_allclose(got["history"], ref.history, rtol=2e-4)
    assert got["best_epoch"] == ref.best_epoch
    np.testing.assert_allclose(got["test_loss"], ref.test_loss, rtol=2e-4)
    assert abs(got["test_acc"] - ref.test_acc) <= 2e-3
