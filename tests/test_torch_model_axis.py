"""The port's model axis (heads over a model group) in one process, against
the JAX package.

* Which leaves split: ``parallel.sharding.split_leaf`` and ``param_split``
  against the JAX ``head_leaf_spec`` on every parameter of every preset
  (Cora, Citeseer, Pubmed, PPI), both layer kinds, at M = 1, 2, 3, 4 and 8.
* The per-rank code: ``models.gat.apply_gat_pieces`` runs each split layer
  once per model index with that rank's heads (``params_from_jax(...,
  model=(m, 2))``) and joins the pieces with ``torch.cat`` / their sum / H,
  as the model group's ``gather_heads`` / ``sum_heads`` join them; for all
  four layer types at M = 2, on a model of 4 and 3 heads (split, then
  replicated: 3 does not divide by 2), the output and the gradients of
  every model rank's leaves, put together, against the JAX model on one
  device, to 1e-5 of each quantity's largest value. The dense types also
  by receiver rows at ``(D, M) = (2, 2)``
  (``parallel.ring_model.dense_rows_grid``: the same per-rank layer, its
  sender tables joined by ``torch.cat``), forward and gradients.
* A split state: sliced, merged and saved, the checkpoint restores to the
  whole state bit for bit; a whole checkpoint restored into a rank's share
  equals the slice.
* The dropout generators of a mesh: shared by the model ranks of a data
  index, apart for their heads.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygat_tpu.graph import build_graph as jbuild_graph
from pygat_tpu.models.gat import GATConfig as JConfig
from pygat_tpu.models.gat import apply_gat as japply_gat
from pygat_tpu.models.gat import init_gat as jinit_gat
from pygat_tpu.models.presets import PRESETS as JPRESETS
from pygat_tpu.parallel.mesh import MODEL_AXIS
from pygat_tpu.parallel.sharding import head_leaf_spec
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from pygat_tpu_torch.graph import build_graph
from pygat_tpu_torch.models.convert import params_from_jax
from pygat_tpu_torch.models.gat import (
    GATConfig,
    HeadGenerators,
    apply_gat_pieces,
    parameters,
)
from pygat_tpu_torch.parallel.distributed import (
    merge_states,
    restore_state,
    slice_state,
)
from pygat_tpu_torch.parallel.mesh import Mesh
from pygat_tpu_torch.parallel.ring_model import dense_rows_grid
from pygat_tpu_torch.parallel.sharding import (
    head_slice,
    param_split,
    split_leaf,
)
from pygat_tpu_torch.train import checkpoint as ckpt
from pygat_tpu_torch.train.loop import _dropout_generator, rows_neighborhood
from pygat_tpu_torch.train.state import (
    init_state,
    leaf_split,
    make_optimizer,
    tensor_leaves,
)

TYPES = ("GAT_sparse", "GATv2_sparse", "GAT", "GATv2")
CFG = dict(nlayers=2, nheads=(4, 3), nfeats=(12, 6, 4), dropout=0.0,
           alpha=0.2, skip_connection=True)
N = 150


@pytest.mark.parametrize("preset", ["cora", "citeseer", "pubmed", "ppi"])
def test_split_decision_matches_head_leaf_spec(preset):
    """Every leaf of every preset's model, both kinds, at M = 1, 2, 3, 4,
    8: split exactly where ``head_leaf_spec`` shards on ``model``."""
    for lt in ("GAT_sparse", "GATv2_sparse"):
        cfg = JConfig(layer_type=lt, **JPRESETS[preset])
        shapes = jax.eval_shape(lambda: jinit_gat(jax.random.PRNGKey(0),
                                                  cfg))
        for m in (1, 2, 3, 4, 8):
            got = param_split(shapes, m)
            for layer, flags in zip(shapes, got):
                for leaf, flag in zip(layer, flags):
                    if leaf is None:
                        assert flag is None
                        continue
                    spec = head_leaf_spec(leaf, m)
                    want = len(spec) > 0 and spec[0] == MODEL_AXIS
                    assert flag == split_leaf(leaf.shape, m) == want, (
                        lt, m, leaf)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(18)
    s = np.concatenate([rng.integers(0, N, N * 4), np.arange(N)])
    r = np.concatenate([rng.integers(0, N, N * 4), np.arange(N)])
    gj = jbuild_graph(s, r, None, N)
    gt = build_graph(s, r, None, N, device="cpu")
    x = np.zeros((gj.num_nodes_padded, CFG["nfeats"][0]), np.float32)
    x[:N] = rng.standard_normal((N, CFG["nfeats"][0]))
    return gj, gt, x


def _numpy_params(cfg, rng):
    """The JAX model's parameters (their shapes from ``init_gat``, traced
    only), drawn with numpy: uniform on the xavier bound of each leaf's
    last two axes."""
    shapes = jax.eval_shape(lambda: jinit_gat(jax.random.PRNGKey(0), cfg))
    return [type(layer)(*(None if t is None else jnp.asarray(rng.uniform(
        -1, 1, t.shape).astype(np.float32) * np.sqrt(6 / sum(t.shape[-2:])))
        for t in layer)) for layer in shapes]


@pytest.fixture(scope="module")
def jax_models(setup):
    """Per layer type: the JAX parameters (numpy), the output's real rows
    and the gradients of sum(sin(out)) over them, on one device."""
    gj, _, x = setup
    rng = np.random.default_rng(30)
    out = {}
    for lt in TYPES:
        cfg = JConfig(layer_type=lt, **CFG)
        params = _numpy_params(cfg, rng)

        def loss(p, cfg=cfg):
            o = japply_gat(p, cfg, jnp.asarray(x), gj, jax.random.PRNGKey(0),
                           train=False)[:N]
            return jnp.sum(jnp.sin(o)), o

        (_, o), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            params)
        out[lt] = ([tuple(None if t is None else np.asarray(t) for t in p)
                    for p in params], np.asarray(o),
                   [np.asarray(t) for p in grads for t in p if t is not None])
    return out


def _close(got, want, what, scale=None):
    scale = max(float(np.abs(want).max()) if scale is None else scale, 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale,
                               err_msg=what)


def _check_rank_grads(lt, ranks, grads_j):
    """Per leaf, the gradients of every model rank's share put together (a
    split leaf's by concatenation; a replicated leaf's are rank 0's, and
    rank 1's copy ran no piece) against the JAX model's. The dense GATv2's
    ``a``, whose gradient is zero in exact arithmetic (the reference's
    per-receiver logit), is held to 1e-5 of the model's largest
    gradient."""
    top = max(float(np.abs(g).max()) for g in grads_j)
    flags = [split_leaf(tuple(t.shape), 2) for t in parameters(ranks[0])]
    assert flags == [True] * 3 + [False] * 3
    for i, (flag, want) in enumerate(zip(flags, grads_j)):
        mine = [parameters(r)[i].grad for r in ranks]
        got = torch.cat(mine) if flag else mine[0]
        if not flag:
            assert mine[1] is None  # a replicated layer runs once here
        if lt == "GATv2" and i % 3 == 1:
            assert float(got.abs().max()) <= 1e-5 * top, f"grad {i}"
            continue
        _close(got.numpy(), want, f"grad {i}")


@pytest.mark.parametrize("lt", TYPES)
def test_per_rank_pieces_match_jax(setup, jax_models, lt):
    """Model ranks 0 and 1 of M = 2, their pieces joined on one device:
    the output and the gradients of every rank's share against the JAX
    model."""
    _, gt, x = setup
    jparams, out_j, grads_j = jax_models[lt]
    cfg = GATConfig(layer_type=lt, **CFG)
    ranks = [params_from_jax(jparams, device="cpu", model=(m, 2))
             for m in range(2)]
    assert [lp.W.shape[0] for lp in ranks[1]] == [2, 3]
    out = apply_gat_pieces(ranks, cfg, torch.from_numpy(x), gt, [None] * 2,
                           train=False)[:N]
    torch.sin(out).sum().backward()
    _close(out.detach().numpy(), out_j, "out")
    _check_rank_grads(lt, ranks, grads_j)


@pytest.mark.parametrize("lt", ["GAT", "GATv2"])
def test_dense_rows_grid_matches_jax(setup, jax_models, lt):
    """The dense types by receiver rows on a (2, 2) mesh run on one device
    (every data index's sender table joined by ``torch.cat``): the two row
    blocks' outputs, stacked, and the gradients of every model rank's
    share against the JAX model."""
    _, gt, x = setup
    jparams, out_j, grads_j = jax_models[lt]
    cfg = GATConfig(layer_type=lt, **CFG)
    ranks = [params_from_jax(jparams, device="cpu", model=(m, 2))
             for m in range(2)]
    n = gt.num_nodes_padded  # 256: two blocks of 128 rows
    xs = [torch.from_numpy(x[k * n // 2:(k + 1) * n // 2]) for k in range(2)]
    nbs = [rows_neighborhood(gt, k * n // 2, (k + 1) * n // 2)
           for k in range(2)]
    out = dense_rows_grid(ranks, cfg, xs, nbs)[:N]
    torch.sin(out).sum().backward()
    _close(out.detach().numpy(), out_j, "out")
    _check_rank_grads(lt, ranks, grads_j)


def _trained_state(lt, jparams, steps=2):
    """A whole state with non-zero Adam moments: ``steps`` Adam steps of
    sum(sin(W)) from the JAX parameters."""
    params = params_from_jax(jparams, device="cpu")
    state = init_state(params, make_optimizer(params, 0.01, 5e-4),
                       torch.Generator().manual_seed(3))
    for _ in range(steps):
        state.optimizer.zero_grad()
        sum(torch.sin(p).sum() for p in parameters(params)).backward()
        state.optimizer.step()
    state.step = steps
    return state


@pytest.mark.parametrize("lt", ["GAT_sparse", "GATv2"])
def test_split_state_saved_gathered_and_restored(jax_models, tmp_path, lt):
    """A whole state sliced for M = 2 (parameters and Adam moments: 1/2 of
    each split leaf a rank; the step counters whole), the slices merged and
    saved: the checkpoint restores into a fresh one-device state equal to
    the whole state bit for bit. And the whole checkpoint restored into a
    fresh rank's share equals that rank's slice bit for bit."""
    whole = _trained_state(lt, jax_models[lt][0])
    shares = [slice_state(whole, m, 2) for m in range(2)]
    for share in shares:
        assert share.split == (True,) * 3 + (False,) * 3
        for t, w, flag in zip(tensor_leaves(share), tensor_leaves(whole),
                              leaf_split(share)):
            assert (t.numel() * 2 if flag else t.numel()) == w.numel()
    ckpt.save(str(tmp_path), 2, "m", merge_states(shares))
    fresh = _trained_state(lt, jax_models[lt][0], steps=0)
    ckpt.restore(ckpt.best_path(str(tmp_path), "m", 2), like=fresh)
    assert fresh.step == whole.step
    for a, b in zip(tensor_leaves(fresh), tensor_leaves(whole)):
        assert torch.equal(a, b)
    ckpt.save(str(tmp_path), 3, "w", whole)
    for m, share in enumerate(shares):
        mine = slice_state(_trained_state(lt, jax_models[lt][0], steps=0),
                           m, 2)
        restore_state(ckpt.best_path(str(tmp_path), "w", 3), mine)
        for a, b in zip(tensor_leaves(mine), tensor_leaves(share)):
            assert torch.equal(a, b)


def test_mesh_dropout_generators():
    """Under a (2, 2) mesh the two model ranks of a data index draw the
    same masks for replicated layers and different ones for their heads;
    at M = 1 the generator is seeded as before the model axis."""
    def mesh(rank, n_model):
        return Mesh(n_data=2, n_model=n_model, rank=rank,
                    world_size=2 * n_model, device=torch.device("cpu"))

    g = [_dropout_generator("cpu", 72, mesh(r, 2)) for r in range(4)]
    assert all(isinstance(x, HeadGenerators) for x in g)

    def draw(gen):
        return torch.rand(8, generator=gen)

    assert torch.equal(draw(g[0].shared), draw(g[1].shared))
    assert not torch.equal(draw(g[2].shared), draw(g[0].shared))
    assert not torch.equal(draw(g[0].heads), draw(g[1].heads))
    one = _dropout_generator("cpu", 72, mesh(1, 1))
    ss = np.random.SeedSequence([73, 1, 0])
    ref = torch.Generator().manual_seed(
        int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1)))
    assert torch.equal(draw(one), draw(ref))
    assert head_slice([(np.zeros((4, 2)), None)], 1, 2)[0][0].shape == (2, 2)
