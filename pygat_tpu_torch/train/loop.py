"""Transductive training loops with the reference's early-stop and
checkpoint-rotation policy (port of ``make_transductive_steps``,
``fit_transductive``, ``make_scanned_epochs_with_best`` and
``fit_transductive_fast`` from ``pygat_tpu/train/loop.py``;
train.py:191-236).

PyTorch runs eagerly, so in :func:`fit_transductive` a train step is a
forward, a backward and an Adam update run op by op, and the host reads the
validation loss every epoch. :func:`fit_transductive_fast` syncs with the
host once per chunk of epochs: :class:`ChunkedEpochs` keeps the per-epoch
metrics and the best model on the device and, on CUDA, captures one epoch
in a CUDA graph and replays it (what ``lax.scan`` under ``jit`` gives the
JAX package). With ``mesh=`` both loops train over a process group: each
data rank holds one node shard and runs the ring attention of
:mod:`~pygat_tpu_torch.parallel` (:func:`_ring_setup`), or for the dense
types its receiver rows' attention (:func:`_dense_setup`); with a model
axis each rank holds and computes its heads of every split layer. The
losses and metrics are reduced over the data group, the gradients
all-reduced over it before Adam, and rank 0 alone writes checkpoints (the
heads gathered first). Both loops on one device ask
:func:`~pygat_tpu_torch.ops.banded.maybe_plan_large` for a large-N plan, as
the JAX package's do: past 300k padded nodes (or with ``PYGAT_BAND=on``)
it returns a band plan, and every layer then runs over the banded order;
with ``PYGAT_CORNER=on`` / ``set_corner("on")`` (and no band plan) it
returns the corner plans, and every layer builds its sender windows by
expand and corner-turn; otherwise (the citation datasets) it returns None.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from pygat_tpu_torch.data.citation import CitationDataset, interleave_citation
from pygat_tpu_torch.graph import Graph
from pygat_tpu_torch.models.gat import (
    GATConfig,
    HeadGenerators,
    apply_gat,
    init_gat,
    parameters,
)
from pygat_tpu_torch.ops import build
from pygat_tpu_torch.ops.banded import BandPlan, maybe_plan_large
from pygat_tpu_torch.ops.large import CscCsrPlans
from pygat_tpu_torch.ops.stream import TILE
from pygat_tpu_torch.parallel.collectives import all_reduce_max, barrier
from pygat_tpu_torch.parallel.distributed import (
    all_reduce_grads,
    restore_params_split,
    restore_state,
    save_state,
    shard_train_state,
)
from pygat_tpu_torch.parallel.mesh import Mesh
from pygat_tpu_torch.parallel.partition import partition_edges, shard_blocks
from pygat_tpu_torch.parallel.ring_model import (
    DenseRowsLoss,
    RingLoss,
    ring_halo_default,
)
from pygat_tpu_torch.parallel.sharding import (
    node_range,
    shard_transductive_data,
)
from pygat_tpu_torch.train import checkpoint as ckpt
from pygat_tpu_torch.train.logging import TrainLogger
from pygat_tpu_torch.train.metrics import accuracy, log_logits, nll_loss
from pygat_tpu_torch.train.state import (
    TrainState,
    init_state,
    leaf_split,
    make_optimizer,
    tensor_leaves,
)
from pygat_tpu_torch.utils.platform import make_generator

def _make_loss(cfg: GATConfig, plans: BandPlan | CscCsrPlans | None = None):
    """``loss(params, x, graph, labels, idx, gen, train) -> (loss, acc,
    out)``."""

    def _loss(params, x, graph, labels, idx, gen, train):
        out = apply_gat(params, cfg, x, graph, gen, train=train, plans=plans)
        lp = log_logits(out)
        loss = nll_loss(lp[idx], labels[idx])
        acc = accuracy(lp[idx], labels[idx])
        return loss, acc, out

    return _loss


def _metrics(loss_fn, out, labels, idx):
    """(loss, accuracy) of the forward output ``out`` over the split
    ``idx``: the ring's reduced ones, or the one device's."""
    if isinstance(loss_fn, RingLoss):
        return loss_fn.metrics(out, labels, idx)
    lp = log_logits(out)
    return nll_loss(lp[idx], labels[idx]), accuracy(lp[idx], labels[idx])


def make_transductive_steps(cfg: GATConfig,
                            plans: BandPlan | CscCsrPlans | None = None,
                            ring: RingLoss | None = None):
    """(train_step, eval_step), over the large-N plan ``plans`` (a band
    plan or the corner plans) when one is given, or with ``ring`` (a
    :class:`~pygat_tpu_torch.parallel.ring_model.RingLoss`, from
    :func:`_ring_setup`) over the ring, this rank's share of the data in,
    the gradients all-reduced before the update.

    ``train_step(state, x, graph, labels, idx) -> (state, loss, acc, out)``
    runs forward with dropout, backward and one Adam update, in place;
    ``eval_step(params, x, graph, labels, idx) -> (loss, acc, out)`` runs the
    forward without dropout or autograd. Losses and accuracies are 0-dim
    tensors on the data's device.
    """

    _loss = ring if ring is not None else _make_loss(cfg, plans)

    def train_step(state: TrainState, x, graph: Graph, labels, idx):
        state.optimizer.zero_grad(set_to_none=True)
        loss, acc, out = _loss(state.params, x, graph, labels, idx,
                               state.generator, True)
        loss.backward()
        if ring is not None:
            all_reduce_grads(state.params, ring.group)
        state.optimizer.step()
        state.step += 1
        return state, loss.detach(), acc, out.detach()

    @torch.no_grad()
    def eval_step(params, x, graph: Graph, labels, idx):
        return _loss(params, x, graph, labels, idx, None, False)

    return train_step, eval_step


def _plan_large(data: CitationDataset, logger: TrainLogger):
    """The trainers' large-N plan for ``data.graph``, logged when there is
    one."""
    plans = maybe_plan_large(data.graph)
    if isinstance(plans, BandPlan):
        logger.log("band_plan", w=plans.w, chunks=plans.num_chunks,
                   slots=plans.num_slots, fill=plans.fill)
    elif plans is not None:
        fwd, inv = plans
        logger.log("corner_plan", rows=fwd.n_rows,
                   passes=[len(fwd.passes), len(inv.passes)],
                   p=[[cp.p for cp in pl.passes] for pl in plans],
                   overflow=[fwd.overflow_total, inv.overflow_total])
    return plans


def _dropout_generator(device, seed: int, mesh: Mesh | None,
                       epoch: int = 0):
    """The dropout generator: seeded with ``seed + 1`` on one device; under
    a mesh with (``seed + 1``, data index, ``epoch``), so each data rank
    draws its own masks (a resumed run's ``epoch`` reseeds it). With a
    model axis a :class:`~pygat_tpu_torch.models.gat.HeadGenerators` pair:
    that generator, shared by the model group (replicated layers), and
    one seeded with (``seed + 1``, data index, ``epoch``, model index + 1)
    for the rank's heads."""
    if mesh is None:
        return make_generator(device, seed + 1)

    def seeded(*words):
        ss = np.random.SeedSequence([seed + 1, mesh.data_index, epoch, *words])
        return make_generator(device, int(ss.generate_state(1, np.uint64)[0]
                                          >> np.uint64(1)))

    if mesh.n_model == 1:
        return seeded()
    return HeadGenerators(seeded(), seeded(mesh.model_index + 1))


def _generators(gen) -> list[torch.Generator]:
    """The torch generators of ``gen`` (one, or a HeadGenerators pair)."""
    return list(gen) if isinstance(gen, HeadGenerators) else [gen]


def _shard_rows(data: CitationDataset, mesh: Mesh):
    """(this rank's rows of ``data``, the interleaved whole dataset): the
    graph repadded to a multiple of ``128 * D`` rows, so each shard's range
    is whole 128-row tiles, and the real nodes dealt over the shards
    (``interleave_citation``), which balances the ring's blocks and the
    dense path's rows."""
    d = mesh.n_data
    unit = TILE * d
    n_pad = data.graph.num_nodes_padded
    want = -(-max(n_pad, int(data.graph.n_node) + 1) // unit) * unit
    data = interleave_citation(data, d, n_pad=want)
    return shard_transductive_data(data, mesh), data


def _ring_setup(cfg: GATConfig, data: CitationDataset, mesh: Mesh,
                logger: TrainLogger):
    """(this rank's share of ``data``, its :class:`RingLoss`) for the ring
    (port of the JAX ``_ring_setup``, loop.py:104-135): the rows of
    :func:`_shard_rows`; build the partition and put this rank's blocks and
    walks on its device, the ring running over the data group. The ring
    keeps the stream kernels under distribution."""
    if not cfg.is_sparse:
        raise ValueError(f"the ring implements the sparse layer types; "
                         f"{cfg.layer_type} runs by rows (_dense_setup)")
    t0 = time.perf_counter()
    d = mesh.n_data
    local, data = _shard_rows(data, mesh)
    part = partition_edges(data.graph, d)
    blocks = shard_blocks(part, mesh.data_index, mesh.device,
                          mesh.data_group)
    logger.log("ring", shards=d, rank=mesh.rank, n_pad=part.n_local * d,
               n_local=part.n_local, block_edges=part.block_edges,
               live_edges=int(part.edge_mask.sum()), h_rows=part.h_rows,
               halo=ring_halo_default(), seconds=time.perf_counter() - t0)
    return local, RingLoss(cfg, blocks, mesh=mesh if mesh.n_model > 1
                           else None)


def rows_neighborhood(graph: Graph, lo: int, hi: int) -> torch.Tensor:
    """Rows ``lo .. hi - 1`` of the graph's dense neighbourhood mask
    (``to_dense(binary=True) > 0``), [hi - lo, N_pad] bool, built from the
    edge list without the whole [N_pad, N_pad] matrix."""
    rcv, snd = graph.receivers.long(), graph.senders.long()
    mine = graph.edge_mask & (rcv >= lo) & (rcv < hi)
    nb = torch.zeros(hi - lo, graph.num_nodes_padded, dtype=torch.bool,
                     device=rcv.device)
    nb[rcv[mine] - lo, snd[mine]] = True
    return nb


def _dense_setup(cfg: GATConfig, data: CitationDataset, mesh: Mesh,
                 logger: TrainLogger):
    """(this rank's share of ``data``, its
    :class:`~pygat_tpu_torch.parallel.ring_model.DenseRowsLoss`) for the
    dense types under a mesh: the rows of :func:`_shard_rows` (the ring's
    layout, so the loss and the early stop are the ring's), and the rank's
    rows of the dense neighbourhood mask; torch has no GSPMD, so the rank
    computes its receiver rows' attention against every sender."""
    t0 = time.perf_counter()
    local, data = _shard_rows(data, mesh)
    lo, hi = node_range(mesh, data.graph.num_nodes_padded)
    nb = rows_neighborhood(data.graph, lo, hi).to(mesh.device)
    logger.log("dense_rows", shards=mesh.n_data, rank=mesh.rank,
               n_pad=data.graph.num_nodes_padded, n_local=hi - lo,
               live_edges=int(nb.sum()), seconds=time.perf_counter() - t0)
    return local, DenseRowsLoss(cfg, nb, mesh)


def _enter_mesh(cfg, data, state, mesh, logger):
    """(data, sharded loss, state) of a run over ``mesh``: the ring for the
    sparse types, receiver rows for the dense ones (``data``, None and
    ``state`` without a mesh); ``state`` replicated from rank 0, and with a
    model axis this rank's heads of it."""
    if mesh is None:
        return data, None, state
    setup = _ring_setup if cfg.is_sparse else _dense_setup
    data, loss = setup(cfg, data, mesh, logger)
    return data, loss, shard_state(state, mesh, logger)


def shard_state(state: TrainState, mesh: Mesh, logger: TrainLogger
                ) -> TrainState:
    """``state`` replicated from rank 0, and with a model axis this rank's
    heads of it, logged once (``model_axis``: which parameters are split
    and which replicated, and the bytes of this rank's split state,
    parameters and Adam moments, against the whole)."""
    state = shard_train_state(state, mesh)
    if mesh.n_model > 1 and mesh.is_main:
        logger.log("model_axis", **_split_report(state, mesh))
    return state


def _split_report(state: TrainState, mesh: Mesh) -> dict:
    names = [f"{k}{i}" for i, lp in enumerate(state.params)
             for k, t in zip(lp._fields, lp) if t is not None]
    flags = list(state.split) or [False] * len(names)
    leaves = tensor_leaves(state)
    split_bytes = sum(t.numel() * t.element_size()
                      for t, f in zip(leaves, leaf_split(state)) if f)
    return dict(split=[n for n, f in zip(names, flags) if f],
                replicated=[n for n, f in zip(names, flags) if not f],
                split_state_bytes=split_bytes,
                whole_split_state_bytes=split_bytes * mesh.n_model)


@dataclass
class FitResult:
    best_epoch: int
    best_val_loss: float
    test_loss: float
    test_acc: float
    epochs_run: int
    state: Any
    history: list = field(default_factory=list)
    # fit_transductive_fast on CUDA: replays of the captured epoch, and the
    # kernel launches one replay holds, by kernel name (else 0 and empty)
    graph_replays: int = 0
    captured_launches: dict = field(default_factory=dict)


def fit_transductive(
    cfg: GATConfig,
    data: CitationDataset,
    *,
    lr: float,
    weight_decay: float,
    epochs: int,
    patience: int,
    seed: int = 72,
    fastmode: bool = False,
    checkpoint_dir: str | None = None,
    dataset_tag: str = "cora",
    logger: TrainLogger | None = None,
    log_every: int = 1,
    init_params: Any = None,
    resume: bool = False,
    mesh: Mesh | None = None,
) -> FitResult:
    """Reference policy: track best val loss, patience counter, save every
    epoch, rotate non-best, restore best, test (train.py:191-236).

    ``mesh`` (a :class:`~pygat_tpu_torch.parallel.mesh.Mesh` of the
    process group; every rank calls this with the whole ``data`` on its
    device) trains over the ring (the sparse types) or by receiver rows
    (the dense ones), for either of the JAX package's partitions (torch
    has no GSPMD; the JAX package's two compute the same thing), with each
    rank's heads of every split layer when the mesh has a model axis.
    Every rank then takes the same early-stop and best-epoch decisions
    from the reduced validation loss; rank 0 writes the checkpoints, in
    the single-device format (every rank gathers the heads with it), so a
    run resumes on one device or under any mesh. Each data rank draws its
    own dropout masks (:func:`_dropout_generator`).

    Runs on the device of ``data``. Parameters are drawn from a CPU
    generator seeded with ``seed`` (the same initial weights on every
    device); dropout draws from a generator on the data's device seeded
    with ``seed + 1``.

    ``resume=True``: restore the newest checkpoint under ``checkpoint_dir``
    (parameters, Adam moments, generator state) and continue the epoch
    count / best-val / patience bookkeeping from its header.
    """
    logger = logger or TrainLogger()
    device = data.features.device
    if init_params is not None:
        params = init_params
    else:
        params = init_gat(cfg, make_generator("cpu", seed), device=device)
    state = init_state(params, make_optimizer(params, lr, weight_decay),
                       _dropout_generator(device, seed, mesh))
    writes = mesh is None or mesh.is_main

    start_epoch = 0
    resumed_best = None
    if resume and checkpoint_dir:
        found = ckpt.latest(checkpoint_dir, dataset_tag)
        if found is not None:
            _, path = found
            state, header = ckpt.restore(path, like=state)
            start_epoch = header["epoch"] + 1
            resumed_best = header
            if mesh is not None:
                state.generator = _dropout_generator(device, seed, mesh,
                                                     start_epoch)
            logger.log("resume", epoch=header["epoch"],
                       best=header.get("best"), path=path,
                       from_best=(header["epoch"] == header.get("best_epoch")))
    data, ring, state = _enter_mesh(cfg, data, state, mesh, logger)
    plans = _plan_large(data, logger) if mesh is None else None
    train_step, eval_step = make_transductive_steps(cfg, plans, ring)

    x, g, labels = data.features, data.graph, data.labels

    best = float("inf")
    best_epoch = 0
    bad_counter = 0
    if resumed_best is not None and resumed_best.get("best") is not None:
        best = float(resumed_best["best"])
        best_epoch = int(resumed_best.get("best_epoch", start_epoch - 1))
        bad_counter = int(resumed_best.get("bad", 0))
    history = []
    epoch = start_epoch - 1

    for epoch in range(start_epoch, epochs):
        t0 = time.time()
        state, loss_tr, acc_tr, out_tr = train_step(state, x, g, labels, data.idx_train)
        if fastmode:
            # reference fastmode: reuse the training-forward output for val
            with torch.no_grad():
                loss_val, acc_val = _metrics(ring, out_tr, labels,
                                             data.idx_val)
        else:
            loss_val, acc_val, _ = eval_step(state.params, x, g, labels, data.idx_val)

        loss_val = float(loss_val)
        if epoch % log_every == 0 or epoch == epochs - 1:
            logger.log(
                "epoch",
                epoch=epoch,
                loss_train=float(loss_tr),
                acc_train=float(acc_tr),
                loss_val=loss_val,
                acc_val=float(acc_val),
                time=time.time() - t0,
            )
        history.append(loss_val)

        if loss_val < best:
            best = loss_val
            best_epoch = epoch
            bad_counter = 0
        else:
            bad_counter += 1
        if checkpoint_dir:
            save_state(mesh, checkpoint_dir, epoch, dataset_tag, state,
                       extra={"best": best, "best_epoch": best_epoch,
                              "bad": bad_counter})
        # >= (not ==): a resumed patience-stopped run restores bad_counter
        # already at the limit and must stop again, not train past it
        if bad_counter >= patience:
            break
        if checkpoint_dir and writes:
            ckpt.rotate_below_best(checkpoint_dir, dataset_tag, best_epoch)

    if checkpoint_dir:
        # keep the final-epoch checkpoint too: resume then continues from
        # where the run stopped instead of replaying post-best epochs
        if writes:
            ckpt.rotate_above_best(checkpoint_dir, dataset_tag, best_epoch,
                                   keep_epoch=epoch)
        barrier()  # every rank reads the best checkpoint rank 0 wrote
        state, _ = restore_state(
            ckpt.best_path(checkpoint_dir, dataset_tag, best_epoch), state)

    test_loss, test_acc, _ = eval_step(state.params, x, g, labels, data.idx_test)
    logger.log("test", loss=float(test_loss), accuracy=float(test_acc))
    return FitResult(
        best_epoch=best_epoch,
        best_val_loss=best,
        test_loss=float(test_loss),
        test_acc=float(test_acc),
        epochs_run=epoch + 1,
        state=state,
        history=history,
    )


def _agree_on_capture(error: str | None, device) -> str | None:
    """Every rank's verdict on its CUDA-graph capture, made one: None when
    the capture held on every rank, else this rank's ``error``, or a note
    that another rank's capture failed. Every rank then replays, or every
    rank runs eagerly: a rank replaying its captured NCCL calls while
    another issues them eagerly would deadlock the group. One all-reduce
    (of one element on ``device``)."""
    failed = torch.tensor([0.0 if error is None else 1.0], device=device)
    if float(all_reduce_max(failed)) == 0.0:
        return None
    return error or "the capture failed on another rank"


class ChunkedEpochs:
    """``n_epochs`` full epochs (train step, validation, best-model
    tracking) per :meth:`run`, with no host sync inside the chunk: the
    counterpart of ``make_scanned_epochs_with_best``.

    Everything an epoch reads or writes lives in device tensors that keep
    their address: the state (updated in place), the per-epoch metrics
    ``[4, n_epochs]`` (train loss, train accuracy, validation loss,
    validation accuracy), the epoch counter, and the best validation loss,
    its epoch and a copy of its parameters, updated with ``torch.where``
    under the reference's gate: an epoch past ``max_epochs`` never becomes
    the best, and with ``patience`` neither does an epoch that runs after
    the host's early stop would have fired (the chunk's overshoot), so the
    selected model is one the per-epoch policy could reach.

    On a CUDA device the epoch is captured once in a CUDA graph (after one
    warm-up epoch on a side stream whose effects are undone) and replayed;
    the optimizer must then be capturable and the dropout generator is
    registered with the graph. A replay launches the kernels without
    passing through their Python wrappers, whose counters it leaves alone:
    ``captured_launches`` holds what one replay launches, by kernel name
    (the wrapper calls the capture recorded), and ``graph_replays`` counts
    the replays. On the CPU the epochs run eagerly.

    With ``ring`` (a run over a mesh) the epoch reduces its metrics and
    all-reduces its gradients, and on CUDA the capture holds those NCCL
    calls too. If they will not capture on some rank, the ranks agree on it
    (:func:`_agree_on_capture`) so that none replays while another runs
    eagerly; then on every rank the error is kept in ``capture_error`` (the
    caller logs it, once), the state is put back as it was before, and
    every chunk runs its epochs eagerly.
    """

    def __init__(self, cfg: GATConfig, state: TrainState, x, graph: Graph,
                 labels, idx_train, idx_val, *, n_epochs: int, max_epochs: int,
                 patience: int | None = None, fastmode: bool = False,
                 plans: BandPlan | CscCsrPlans | None = None,
                 ring: RingLoss | None = None):
        dev = x.device
        self.state = state
        self.n_epochs = n_epochs
        self._args = (x, graph, labels, idx_train, idx_val)
        self._ring = ring
        self._loss = ring if ring is not None else _make_loss(cfg, plans)
        self.capture_error: str | None = None
        self._max_epochs = max_epochs
        self._patience = patience
        self._fastmode = fastmode
        self.best_val = torch.full((), float("inf"), device=dev)
        self.best_epoch = torch.full((), -1, dtype=torch.int64, device=dev)
        self.best_params = [
            type(p)(*(None if t is None else t.detach().clone() for t in p))
            for p in state.params]
        self._step = torch.full((), state.step, dtype=torch.int64, device=dev)
        self._metrics = torch.zeros(4, n_epochs, device=dev)
        self._slot = torch.zeros(1, dtype=torch.int64, device=dev)
        self._graph = None
        self.captured_launches: dict[str, int] = {}
        self.graph_replays = 0

    def _epoch(self) -> None:
        state = self.state
        x, graph, labels, idx_train, idx_val = self._args
        state.optimizer.zero_grad(set_to_none=True)
        loss_tr, acc_tr, out = self._loss(state.params, x, graph, labels,
                                          idx_train, state.generator, True)
        loss_tr.backward()
        if self._ring is not None:
            all_reduce_grads(state.params, self._ring.group)
        state.optimizer.step()
        self._step += 1
        with torch.no_grad():
            if self._fastmode:
                # reference fastmode: reuse the training-forward output
                loss_val, acc_val = _metrics(self._ring, out.detach(), labels,
                                             idx_val)
            else:
                loss_val, acc_val, _ = self._loss(
                    state.params, x, graph, labels, idx_val, None, False)
            # this epoch's index is step - 1; epochs past the budget never
            # update the best model
            improved = (loss_val < self.best_val) & (
                self._step - 1 < self._max_epochs)
            if self._patience is not None:
                # the host stops after epoch e once e - best_epoch >=
                # patience, so gate on the previous epoch (the one the host
                # checked); best_epoch freezes once gated
                improved &= (self._step - 2 - self.best_epoch) < self._patience
            self.best_val.copy_(torch.where(improved, loss_val, self.best_val))
            self.best_epoch.copy_(
                torch.where(improved, self._step - 1, self.best_epoch))
            for best, new in zip(parameters(self.best_params),
                                 parameters(state.params)):
                best.copy_(torch.where(improved, new, best))
            row = torch.stack([loss_tr.detach(), acc_tr, loss_val, acc_val])
            self._metrics.index_copy_(1, self._slot, row[:, None])
            self._slot += 1

    def _capture(self) -> None:
        state = self.state
        carry = (tensor_leaves(state) + parameters(self.best_params)
                 + [self.best_val, self.best_epoch, self._step, self._slot])
        # detached copies: a clone that tracks gradients would keep the
        # parameters' AccumulateGrad nodes alive on this stream, and the
        # captured backward would then sync with it and break the capture
        saved = [t.detach().clone() for t in carry]
        gens = _generators(state.generator)
        gen_state = [g.get_state() for g in gens]
        # one eager epoch on a side stream builds and loads the kernels and
        # settles the allocator and the library workspaces; then undo it
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self._epoch()
        torch.cuda.current_stream().wait_stream(side)
        with torch.no_grad():
            for t, old in zip(carry, saved):
                t.copy_(old)
        del saved
        for g, st in zip(gens, gen_state):
            g.set_state(st)
        before = build.launch_counts()
        graph = torch.cuda.CUDAGraph()
        for g in gens:
            graph.register_generator_state(g)
        if self._ring is not None:
            # the collectives may refuse the capture: keep what to put back
            saved = [t.detach().clone() for t in carry]
            gen_state = [g.get_state() for g in gens]
            error = None
            try:
                with torch.cuda.graph(graph):
                    self._epoch()
            except RuntimeError as exc:
                torch.cuda.synchronize()
                error = f"{type(exc).__name__}: {exc}"
            # a capture runs nothing, so no rank has sent yet: agree now
            error = _agree_on_capture(error, self._metrics.device)
            if error is not None:
                with torch.no_grad():
                    for t, old in zip(carry, saved):
                        t.copy_(old)
                for g, st in zip(gens, gen_state):
                    g.set_state(st)
                self.capture_error = error
                return
            del saved
        else:
            with torch.cuda.graph(graph):
                self._epoch()
        # the wrapper calls of the capture: recorded, run at every replay
        self.captured_launches = {
            name: n - before[name]
            for name, n in build.launch_counts().items()}
        self._graph = graph

    def run(self) -> list[list[float]]:
        """Run the chunk; returns the four metric rows, read with one
        transfer (the chunk's only host sync)."""
        self._slot.zero_()
        on_cuda = self._metrics.device.type == "cuda"
        if on_cuda and self._graph is None and self.capture_error is None:
            self._capture()
        on_cuda = on_cuda and self._graph is not None
        for _ in range(self.n_epochs):
            if on_cuda:
                self._graph.replay()
                self.graph_replays += 1
            else:
                self._epoch()
        self.state.step += self.n_epochs
        return self._metrics.tolist()

    def set_best(self, best_val: float, best_epoch: int) -> None:
        """Continue a resumed run's best-model bookkeeping (the caller loads
        ``best_params`` itself)."""
        self.best_val.fill_(best_val)
        self.best_epoch.fill_(best_epoch)


def fit_transductive_fast(
    cfg: GATConfig,
    data: CitationDataset,
    *,
    lr: float,
    weight_decay: float,
    epochs: int,
    patience: int,
    seed: int = 72,
    fastmode: bool = False,
    epoch_chunk: int = 50,
    checkpoint_dir: str | None = None,
    dataset_tag: str = "cora",
    logger: TrainLogger | None = None,
    log_every: int = 50,
    init_params: Any = None,
    resume: bool = False,
    mesh: Mesh | None = None,
) -> FitResult:
    """Same policy and result as :func:`fit_transductive` (the best-val
    parameters are restored exactly, tracked on the device), but the host
    syncs once per ``epoch_chunk`` epochs: early stopping can overshoot by up
    to ``epoch_chunk - 1`` epochs of extra compute, never changing the
    selected model. Checkpoints are written at chunk boundaries (full state)
    rather than every epoch. Seeds as :func:`fit_transductive`, so both
    loops see the same initial weights and dropout masks.

    ``resume=True`` continues exactly from the newest chunk checkpoint: the
    header carries the val-loss history (for the patience policy) and the
    best-val bookkeeping; the best parameters reload from the
    ``{tag}-best`` checkpoint refreshed at every chunk boundary.

    ``mesh`` as in :func:`fit_transductive`. On CUDA the captured epoch
    then holds the NCCL calls (the metrics' and the gradients' all-reduces,
    the ring's sends). Should the capture refuse them on any rank, every
    rank runs every chunk's K epochs eagerly, and the loop says so in one
    ``capture`` record of the log.
    """
    logger = logger or TrainLogger()
    device = data.features.device
    if init_params is not None:
        params = init_params
    else:
        params = init_gat(cfg, make_generator("cpu", seed), device=device)
    optimizer = make_optimizer(params, lr, weight_decay,
                               capturable=device.type == "cuda")
    state = init_state(params, optimizer, _dropout_generator(device, seed,
                                                             mesh))
    best_tag = dataset_tag + "-best"
    writes = mesh is None or mesh.is_main

    history: list[float] = []
    resumed = None
    if resume and checkpoint_dir:
        found = ckpt.latest(checkpoint_dir, dataset_tag)
        if found is not None:
            state, resumed = ckpt.restore(found[1], like=state)
            history = [float(v) for v in resumed.get("history", [])]
            if mesh is not None:
                state.generator = _dropout_generator(device, seed, mesh,
                                                     len(history))
    data, ring, state = _enter_mesh(cfg, data, state, mesh, logger)
    x, g, labels = data.features, data.graph, data.labels
    plans = _plan_large(data, logger) if mesh is None else None
    chunk = ChunkedEpochs(cfg, state, x, g, labels, data.idx_train,
                          data.idx_val, n_epochs=epoch_chunk,
                          max_epochs=epochs, patience=patience,
                          fastmode=fastmode, plans=plans, ring=ring)
    if resumed is not None:
        best_val = float(resumed.get("best", np.inf))
        best_epoch = int(resumed.get("best_epoch", -1))
        chunk.set_best(best_val, best_epoch)
        bfound = ckpt.latest(checkpoint_dir, best_tag)
        if bfound is not None and best_epoch >= 0:
            restore_params_split(bfound[1], state, chunk.best_params)
        logger.log("resume", epoch=len(history) - 1, best=best_val,
                   path=found[1])

    t0 = time.time()
    stopped = False
    capture_logged = False
    while len(history) < epochs and not stopped:
        chunk_tr, chunk_acc_tr, chunk_vals, chunk_acc_val = chunk.run()
        if chunk.capture_error is not None and not capture_logged:
            logger.log("capture", eager=True, error=chunk.capture_error)
            capture_logged = True
        for j, lv in enumerate(chunk_vals):
            epoch_idx = len(history)
            history.append(lv)
            if epoch_idx % log_every == 0:
                logger.log("epoch", epoch=epoch_idx, loss_train=chunk_tr[j],
                           acc_train=chunk_acc_tr[j], loss_val=lv,
                           acc_val=chunk_acc_val[j], time=time.time() - t0)
                t0 = time.time()
            # reference patience policy over the full history
            if epoch_idx - int(np.argmin(history)) >= patience:
                stopped = True
                break
            if epoch_idx + 1 >= epochs:
                break
        if checkpoint_dir:
            # chunk-boundary checkpoint with full resume bookkeeping: the
            # header carries the history (patience state) and the best val;
            # the best parameters refresh in the {tag}-best file
            be = int(chunk.best_epoch)
            last = len(history) - 1
            save_state(mesh, checkpoint_dir, last, dataset_tag, state,
                       extra={"best": float(chunk.best_val),
                              "best_epoch": be, "history": history})
            if writes:
                ckpt.rotate_below_best(checkpoint_dir, dataset_tag, last)
            if be >= 0:
                save_state(mesh, checkpoint_dir, be, best_tag, state,
                           params=chunk.best_params)
                if writes:
                    ckpt.rotate_except(checkpoint_dir, best_tag, be)

    # the returned state carries the best parameters (and the last Adam
    # moments), as the JAX package's does; the {tag}-best file of the last
    # chunk boundary already holds them
    with torch.no_grad():
        for p, best in zip(parameters(state.params),
                           parameters(chunk.best_params)):
            p.copy_(best)
    best_epoch = int(chunk.best_epoch)

    _, eval_step = make_transductive_steps(cfg, plans, ring)
    test_loss, test_acc, _ = eval_step(state.params, x, g, labels, data.idx_test)
    logger.log("test", loss=float(test_loss), accuracy=float(test_acc))
    return FitResult(
        best_epoch=best_epoch,
        best_val_loss=float(chunk.best_val),
        test_loss=float(test_loss),
        test_acc=float(test_acc),
        epochs_run=len(history),
        state=state,
        history=history,
        graph_replays=chunk.graph_replays,
        captured_launches=chunk.captured_launches,
    )
