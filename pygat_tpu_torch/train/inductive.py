"""Inductive (PPI) training loops with the reference's early-stop and
checkpoint-rotation policy (port of ``make_inductive_steps``,
``fit_inductive``, ``_banked_eval_fn``, ``make_banked_epochs`` and
``fit_inductive_banked``, ``stack_batches`` and ``fit_inductive_fast``
from ``pygat_tpu/train/loop.py``; train_ppi.py:112-216, whose broken
checkpoint rotation is replaced by the intended policy).

Three loops, all eager; the banked and the stacked ones also
data-parallel over a process group (``mesh=``), the banked one in one
process over ``dp`` slots too:

* :func:`fit_inductive` builds every epoch's block-diagonal batches on the
  host (:func:`~pygat_tpu_torch.data.ppi.make_batches`, walks included),
  shuffled by ``np.random.default_rng(seed + epoch)``, and reads the
  validation loss every epoch;
* :func:`fit_inductive_banked` keeps every graph on the device once
  (:func:`~pygat_tpu_torch.data.ppi.build_bank`) and collates each batch
  there (:func:`~pygat_tpu_torch.data.ppi.assemble_banked_batch`);
  :class:`BankedEpochs` runs a chunk of epochs with one host read, keeping
  the per-epoch metrics, the best model and the patience gate on the
  device;
* :func:`fit_inductive_fast` builds each epoch's batches on the host as
  the per-batch loop does, stacks them (:func:`stack_batches`), copies
  them to the device at once and reads the epoch's metrics once.

The banked loop draws each epoch's graph order on the host with the same
``np.random.default_rng(seed + epoch)`` shuffle as the per-batch loop, where
the JAX package draws ``jax.random.permutation`` on the device (the same
distribution, not the same bits); with the same order the two loops train
on the same batches, and the members of every batch are host integers, so
assembling one needs no device read. Padding slots of the last batch
repeat the first members, as in the JAX package, and drop out of every
loss through the masks. There is no large-N plan here: the JAX inductive
loops never ask for one.
"""

from __future__ import annotations

import time
from typing import Any, NamedTuple

import numpy as np
import torch

from pygat_tpu_torch.models.gat import GATConfig, apply_gat, init_gat, parameters
from pygat_tpu_torch.train import checkpoint as ckpt
from pygat_tpu_torch.train.logging import TrainLogger
from pygat_tpu_torch.parallel.collectives import (
    all_reduce_mean,
    all_reduce_sum,
)
from pygat_tpu_torch.parallel.distributed import (
    all_reduce_grads,
    restore_params_split,
    restore_state,
    save_state,
)
from pygat_tpu_torch.parallel.mesh import Mesh
from pygat_tpu_torch.train.loop import (
    FitResult,
    _dropout_generator,
    shard_state,
)
from pygat_tpu_torch.train.metrics import bce_with_logits, f1_counts, micro_f1
from pygat_tpu_torch.train.state import TrainState, init_state, make_optimizer
from pygat_tpu_torch.utils.platform import make_generator, resolve_device


def _make_loss(cfg: GATConfig, mesh: Mesh | None = None):
    """``loss(params, x, graph, y, gen, train) -> (loss, f1, out)``: mean
    BCE over the graph's real rows and their micro-F1. ``mesh``: a mesh
    with a model axis, whose ranks hold their heads of ``params``."""
    model = mesh if mesh is not None and mesh.n_model > 1 else None

    def _loss(params, x, graph, y, gen, train):
        out = apply_gat(params, cfg, x, graph, gen, train=train, mesh=model)
        mask = graph.node_mask
        loss = bce_with_logits(out, y, mask=mask)
        with torch.no_grad():
            f1 = micro_f1(out, y, mask=mask)
        return loss, f1, out

    return _loss


def make_inductive_steps(cfg: GATConfig):
    """(train_step, eval_step).

    ``train_step(state, x, graph, y) -> (state, loss, f1)`` runs forward
    with dropout, backward and one Adam update, in place;
    ``eval_step(params, x, graph, y) -> (loss, f1, tp, fp, fn)`` runs the
    forward without dropout or autograd. All results are 0-dim tensors on
    the data's device.
    """
    _loss = _make_loss(cfg)

    def train_step(state: TrainState, x, graph, y):
        state.optimizer.zero_grad(set_to_none=True)
        loss, f1, _ = _loss(state.params, x, graph, y, state.generator, True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, loss.detach(), f1

    @torch.no_grad()
    def eval_step(params, x, graph, y):
        loss, f1, out = _loss(params, x, graph, y, None, False)
        tp, fp, fn = f1_counts(out, y, mask=graph.node_mask)
        return loss, f1, tp, fp, fn

    return train_step, eval_step


def _init(cfg, seed, lr, weight_decay, init_params, device) -> TrainState:
    """Parameters drawn from a CPU generator seeded with ``seed`` (the same
    weights on every device), or ``init_params``; dropout from a generator
    on ``device`` seeded with ``seed + 1``."""
    params = (init_params if init_params is not None
              else init_gat(cfg, make_generator("cpu", seed), device=device))
    return init_state(params, make_optimizer(params, lr, weight_decay),
                      make_generator(device, seed + 1))


def fit_inductive(
    cfg: GATConfig,
    data,  # pygat_tpu_torch.data.ppi.PPIData
    *,
    batch_size: int,
    lr: float,
    weight_decay: float,
    epochs: int,
    patience: int,
    seed: int = 72,
    checkpoint_dir: str | None = None,
    dataset_tag: str = "ppi",
    logger: TrainLogger | None = None,
    log_batches: bool = True,
    init_params: Any = None,
    device: torch.device | str | None = None,
) -> FitResult:
    """The per-batch loop (train_ppi.py:112-216) on ``device`` (CUDA unless
    the caller names another device; raises without CUDA): every epoch
    the shuffled train batches, then the validation batches in order; save
    every epoch, drop checkpoints older than the best, stop after
    ``patience`` epochs without a better validation loss, keep the best
    and the last checkpoint and restore the best; then the test loss (the
    mean of its batches) and micro-F1 (from the summed counts). Each epoch
    logs a ``ppi_epoch`` record (the means of its batches); ``log_batches``
    adds one ``ppi_batch`` record per batch."""
    from pygat_tpu_torch.data.ppi import batch_bounds, make_batches

    device = resolve_device(device)
    logger = logger or TrainLogger()
    state = _init(cfg, seed, lr, weight_decay, init_params, device)
    train_step, eval_step = make_inductive_steps(cfg)

    # ONE static batch shape across all splits and epochs
    bounds = [batch_bounds(g, batch_size)
              for g in (data.train, data.valid, data.test)]
    n_pad = max(b[0] for b in bounds)
    e_pad = max(b[1] for b in bounds)

    def batches(graphs, **kw):
        return make_batches(graphs, batch_size, n_pad=n_pad, e_pad=e_pad,
                            device=device, **kw)

    best = float("inf")
    best_epoch = 0
    bad_counter = 0
    history: list[float] = []
    epoch = -1

    for epoch in range(epochs):
        t_epoch = t0 = time.time()
        tr_loss, tr_f1 = [], []
        for bi, pb in enumerate(batches(data.train, shuffle=True,
                                        seed=seed + epoch)):
            state, loss_tr, f1_tr = train_step(state, pb.features,
                                               pb.batch.graph, pb.labels)
            tr_loss.append(loss_tr)
            tr_f1.append(f1_tr)
            if log_batches:
                logger.log("ppi_batch", split="train", epoch=epoch, batch=bi,
                           loss=float(loss_tr), f1=float(f1_tr),
                           time=time.time() - t0)
            t0 = time.time()

        val_losses, val_f1 = [], []
        for bi, pb in enumerate(batches(data.valid)):
            loss_v, f1_v, *_ = eval_step(state.params, pb.features,
                                         pb.batch.graph, pb.labels)
            if log_batches:
                logger.log("ppi_batch", split="valid", epoch=epoch, batch=bi,
                           loss=float(loss_v), f1=float(f1_v),
                           time=time.time() - t0)
            t0 = time.time()
            val_losses.append(float(loss_v))
            val_f1.append(float(f1_v))
        loss_val = sum(val_losses) / len(val_losses)
        history.append(loss_val)
        logger.log("ppi_epoch", epoch=epoch,
                   loss_train=float(torch.stack(tr_loss).mean()),
                   f1_train=float(torch.stack(tr_f1).mean()),
                   loss_val=loss_val, f1_val=sum(val_f1) / len(val_f1),
                   time=time.time() - t_epoch)

        if checkpoint_dir:
            ckpt.save(checkpoint_dir, epoch, dataset_tag, state)
        if loss_val < best:
            best = loss_val
            best_epoch = epoch
            bad_counter = 0
        else:
            bad_counter += 1
        if bad_counter >= patience:
            break
        if checkpoint_dir:
            ckpt.rotate_below_best(checkpoint_dir, dataset_tag, best_epoch)

    if checkpoint_dir:
        # keep the final-epoch checkpoint too: a resume then continues from
        # where the run stopped instead of replaying post-best epochs
        ckpt.rotate_above_best(checkpoint_dir, dataset_tag, best_epoch,
                               keep_epoch=epoch)
        state, _ = ckpt.restore(
            ckpt.best_path(checkpoint_dir, dataset_tag, best_epoch), like=state)

    # test: mean batch loss + micro-F1 over the concatenation of all batches
    # (summed counts == concatenated micro-F1), train_ppi.py:155-174
    losses, tp, fp, fn = [], 0.0, 0.0, 0.0
    for pb in batches(data.test):
        loss_t, _, tp_b, fp_b, fn_b = eval_step(state.params, pb.features,
                                                pb.batch.graph, pb.labels)
        losses.append(float(loss_t))
        tp += float(tp_b)
        fp += float(fp_b)
        fn += float(fn_b)
    test_loss = sum(losses) / len(losses)
    test_f1 = 2 * tp / max(2 * tp + fp + fn, 1.0)
    logger.log("test", loss=test_loss, accuracy=test_f1)
    return FitResult(
        best_epoch=best_epoch,
        best_val_loss=best,
        test_loss=test_loss,
        test_acc=test_f1,
        epochs_run=epoch + 1,
        state=state,
        history=history,
    )


# ---------------------------------------------------------------------------
# The banked loop: every graph on the device once, batches collated there.
# ---------------------------------------------------------------------------


def _batch_slots(n_graphs: int, batch_size: int, order: np.ndarray
                 ) -> list[tuple[np.ndarray, np.ndarray]]:
    """(members, live) of each batch of ``order``, the last batch padded
    with its first graphs, which are not live."""
    nb = -(-n_graphs // batch_size)
    pad = nb * batch_size - n_graphs
    if pad:
        order = np.concatenate([order, order[:pad]])
    live = np.arange(nb * batch_size) < n_graphs
    return list(zip(order.reshape(nb, batch_size),
                    live.reshape(nb, batch_size)))


def banked_eval(cfg: GATConfig, bank, batch_size: int,
                mesh: Mesh | None = None):
    """``eval_bank(params) -> (losses [nb], f1s [nb], tp, fp, fn)``: a whole
    split of ``bank`` in order (the padding slots of the last batch repeat
    its first graphs), without dropout or autograd, as device tensors.
    ``mesh``: as :func:`_make_loss` (every rank of the model group calls
    it together)."""
    from pygat_tpu_torch.data.ppi import assemble_banked_batch

    _loss = _make_loss(cfg, mesh)
    slots = _batch_slots(bank.n_graphs, batch_size, np.arange(bank.n_graphs))

    @torch.no_grad()
    def eval_bank(params):
        losses, f1s, counts = [], [], []
        for idx, live in slots:
            x, g, y = assemble_banked_batch(bank, idx, live)
            loss, f1, out = _loss(params, x, g, y, None, False)
            losses.append(loss)
            f1s.append(f1)
            counts.append(torch.stack(f1_counts(out, y, mask=g.node_mask)))
        tp, fp, fn = torch.stack(counts).sum(0)
        return torch.stack(losses), torch.stack(f1s), tp, fp, fn

    return eval_bank


def superstep_slots(n_batches: int, n_data: int
                    ) -> list[tuple[np.ndarray, np.ndarray]]:
    """The data-parallel super-steps over ``n_batches`` batches in order
    (the JAX package's ``superbatch``, loop.py:479-500): super-step ``s``
    takes the batches ``s * D .. s * D + D - 1`` (indices modulo the count,
    so the last one's pad slots repeat earlier batches) and their weights,
    1, or 0 on a pad slot. Returns (batch ids [D], weights [D]) each."""
    s_t = -(-n_batches // n_data)
    ids = np.arange(s_t * n_data)
    batch_of = (ids % n_batches).reshape(s_t, n_data)
    weight = (ids < n_batches).astype(np.float32).reshape(s_t, n_data)
    return list(zip(batch_of, weight))


class BankedEpochs:
    """Banked epochs, ``n_epochs`` per :meth:`run` at most, with no host
    read inside the chunk: the counterpart of ``make_banked_epochs`` on
    one device.

    An epoch trains on the shuffled train bank (the order drawn on the
    host, see the module docstring) and evaluates the validation bank.
    The per-epoch metrics ``[4, n_epochs]`` (mean train loss, mean train
    micro-F1, mean validation loss, mean validation micro-F1), the best
    validation loss, its epoch and a copy of its parameters live on the
    device and are updated with ``torch.where`` under the reference's
    gate, as :class:`~pygat_tpu_torch.train.loop.ChunkedEpochs` does: an
    epoch past ``max_epochs`` never becomes the best, and with
    ``patience`` neither does an epoch that runs after the host's early
    stop would have fired (the chunk's overshoot), so the selected model is
    one the per-batch policy could reach. The epochs run eagerly;
    capturing one in a CUDA graph is later work.

    ``n_data`` > 1, or a ``mesh``, makes the epoch data-parallel, as the
    JAX package's ``make_banked_epochs(mesh=, dp=)``: an optimizer step
    takes ``D`` consecutive batches (:func:`superstep_slots`) and descends
    the weighted mean of their losses (pad slots weigh 0). Under a mesh of
    ``D`` ranks, rank ``r`` computes slot ``r``'s loss and the gradients
    are all-reduced; with ``n_data`` and no mesh one process computes the
    same arithmetic over the ``D`` slots in turn (how the tests pin the
    distributed loop). The metrics are the super-steps' weighted means,
    reduced over the ranks; every rank evaluates the whole validation bank,
    and the validation loss is averaged over the ranks.
    """

    def __init__(self, cfg: GATConfig, state: TrainState, bank_train,
                 bank_val, batch_size: int, *, n_epochs: int, seed: int,
                 max_epochs: int, patience: int | None = None,
                 n_data: int = 1, mesh: Mesh | None = None):
        dev = bank_train.features.device
        self.state = state
        self.n_epochs = n_epochs
        self._bank = bank_train
        self._b = batch_size
        self._seed = seed
        self._loss = _make_loss(cfg, mesh)
        self._eval_val = banked_eval(cfg, bank_val, batch_size, mesh)
        self._max_epochs = max_epochs
        self._patience = patience
        self.best_val = torch.full((), float("inf"), device=dev)
        self.best_epoch = torch.full((), -1, dtype=torch.int64, device=dev)
        self.best_params = [
            type(p)(*(None if t is None else t.detach().clone() for t in p))
            for p in state.params]
        self._metrics = torch.zeros(4, n_epochs, device=dev)
        self._n_data = mesh.n_data if mesh is not None else n_data
        self._mesh = mesh

    def _order(self, epoch: int) -> np.ndarray:
        """The train graphs' order in ``epoch``: the per-batch loop's
        shuffle, ``np.random.default_rng(seed + epoch)``."""
        order = np.arange(self._bank.n_graphs)
        np.random.default_rng(self._seed + epoch).shuffle(order)
        return order

    def _epoch(self, epoch: int, j: int) -> None:
        from pygat_tpu_torch.data.ppi import assemble_banked_batch

        state = self.state
        slots = _batch_slots(self._bank.n_graphs, self._b, self._order(epoch))
        tr_loss, tr_f1 = [], []
        if self._mesh is not None or self._n_data > 1:
            tr_loss, tr_f1 = self._dp_steps(slots)
        for idx, live in slots if not tr_loss else ():
            x, g, y = assemble_banked_batch(self._bank, idx, live)
            state.optimizer.zero_grad(set_to_none=True)
            loss, f1, _ = self._loss(state.params, x, g, y, state.generator,
                                     True)
            loss.backward()
            state.optimizer.step()
            state.step += 1
            tr_loss.append(loss.detach())
            tr_f1.append(f1)
        losses_v, f1s_v, *_ = self._eval_val(state.params)
        with torch.no_grad():
            loss_val = losses_v.mean()
            if self._mesh is not None:
                # every rank evaluated the same bank with the same
                # parameters; the mean makes the early-stop and best-epoch
                # decisions the same bits on every card
                loss_val = all_reduce_mean(loss_val, self._mesh.data_group)
            # epochs past the budget never update the best model
            improved = (loss_val < self.best_val) & (epoch < self._max_epochs)
            if self._patience is not None:
                # the host stops after epoch e once e - best_epoch >=
                # patience, so gate on the previous epoch (the one the host
                # checked); best_epoch freezes once gated
                improved &= (epoch - 1 - self.best_epoch) < self._patience
            self.best_val.copy_(torch.where(improved, loss_val, self.best_val))
            self.best_epoch.copy_(torch.where(
                improved, torch.full_like(self.best_epoch, epoch),
                self.best_epoch))
            for best, new in zip(parameters(self.best_params),
                                 parameters(state.params)):
                best.copy_(torch.where(improved, new, best))
            self._metrics[:, j] = torch.stack([
                torch.stack(tr_loss).mean(), torch.stack(tr_f1).mean(),
                loss_val, f1s_v.mean()])

    def _dp_steps(self, slots):
        """The epoch's data-parallel super-steps over the batches ``slots``;
        returns each one's weighted-mean loss and micro-F1."""
        from pygat_tpu_torch.data.ppi import assemble_banked_batch

        state, mesh = self.state, self._mesh
        losses, f1s = [], []
        for ids, weight in superstep_slots(len(slots), self._n_data):
            wsum = max(float(weight.sum()), 1.0)
            mine = ([mesh.data_index] if mesh is not None
                    else range(self._n_data))
            state.optimizer.zero_grad(set_to_none=True)
            total, parts = 0.0, []
            for j in mine:
                x, g, y = assemble_banked_batch(self._bank, *slots[ids[j]])
                loss, f1, _ = self._loss(state.params, x, g, y,
                                         state.generator, True)
                total = total + loss * (float(weight[j]) / wsum)
                parts.append(torch.stack([loss.detach(), f1])
                             * float(weight[j]))
            total.backward()
            stats = torch.stack(parts).sum(0) / wsum
            if mesh is not None:
                all_reduce_grads(state.params, mesh.data_group)
                stats = all_reduce_sum(stats, mesh.data_group)
            state.optimizer.step()
            state.step += 1
            losses.append(stats[0])
            f1s.append(stats[1])
        return losses, f1s

    def run(self, first_epoch: int, n: int | None = None) -> list[list[float]]:
        """Run epochs ``first_epoch`` .. ``first_epoch + n - 1`` (``n`` at
        most, and by default, ``n_epochs``); returns the four metric rows,
        read with one transfer (the chunk's only host sync)."""
        n = self.n_epochs if n is None else n
        if not 0 < n <= self.n_epochs:
            raise ValueError(f"a chunk runs 1 to {self.n_epochs} epochs, not {n}")
        for j in range(n):
            self._epoch(first_epoch + j, j)
        return self._metrics[:, :n].tolist()

    def set_best(self, best_val: float, best_epoch: int) -> None:
        """Continue a resumed run's best-model bookkeeping (the caller loads
        ``best_params`` itself)."""
        self.best_val.fill_(best_val)
        self.best_epoch.fill_(best_epoch)


def fit_inductive_banked(
    cfg: GATConfig,
    data,  # pygat_tpu_torch.data.ppi.PPIData
    *,
    batch_size: int,
    lr: float,
    weight_decay: float,
    epochs: int,
    patience: int,
    seed: int = 72,
    epoch_chunk: int = 10,
    checkpoint_dir: str | None = None,
    dataset_tag: str = "ppi",
    logger: TrainLogger | None = None,
    log_every: int = 10,
    init_params: Any = None,
    resume: bool = False,
    device: torch.device | str | None = None,
    mesh: Mesh | None = None,
    dp: int | None = None,
) -> FitResult:
    """:func:`fit_inductive` over device-resident banks with one host sync
    per ``epoch_chunk`` epochs: early stopping can overshoot by up to
    ``epoch_chunk - 1`` epochs of extra compute, never changing the
    selected model (the last chunk stops at ``epochs``). Seeds and batch
    order as :func:`fit_inductive`, so both loops train the same model on
    the same batches. Checkpoints at chunk boundaries carry the val-loss
    history and the best bookkeeping in their header, the best parameters
    in the ``{tag}-best`` checkpoint; ``resume=True`` continues exactly
    from the newest ones.

    ``mesh`` (every rank of the group calls this; ``device`` defaults to
    the mesh's) trains data-parallel: one batch a data rank a step, the
    gradients all-reduced over the data group, rank 0's parameters
    broadcast first, each data rank's dropout from its own generator
    (seeded with (``seed + 1``, data index)), and only rank 0 writing
    checkpoints (in the one-device format). With a model axis each rank
    holds and computes its heads of every split layer (``apply_gat(mesh=)``)
    and draws their masks from a generator of its own. ``dp=D`` without a
    mesh runs the same arithmetic in one process (:class:`BankedEpochs`)."""
    from pygat_tpu_torch.data.ppi import bank_bounds, build_bank

    if mesh is not None and dp is not None and dp != mesh.n_data:
        raise ValueError(f"dp={dp} against a mesh of {mesh.n_data} ranks")
    device = resolve_device(device if device is not None or mesh is None
                            else mesh.device)
    logger = logger or TrainLogger()
    state = _init(cfg, seed, lr, weight_decay, init_params, device)
    writes = mesh is None or mesh.is_main
    best_tag = dataset_tag + "-best"

    n_pg, e_pg = bank_bounds([data.train, data.valid, data.test])
    bank_tr = build_bank(data.train, n_pg, e_pg, device)
    bank_va = build_bank(data.valid, n_pg, e_pg, device)
    bank_te = build_bank(data.test, n_pg, e_pg, device)

    history: list[float] = []
    resumed = found = None
    if resume and checkpoint_dir:
        found = ckpt.latest(checkpoint_dir, dataset_tag)
        if found is not None:
            state, resumed = ckpt.restore(found[1], like=state)
            history = [float(v) for v in resumed.get("history", [])]
    if mesh is not None:
        state.generator = _dropout_generator(device, seed, mesh, len(history))
        state = shard_state(state, mesh, logger)
    chunk = BankedEpochs(cfg, state, bank_tr, bank_va, batch_size,
                         n_epochs=epoch_chunk, seed=seed, max_epochs=epochs,
                         patience=patience, n_data=dp or 1, mesh=mesh)
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
    while len(history) < epochs and not stopped:
        n = min(epoch_chunk, epochs - len(history))
        chunk_tr, chunk_ftr, chunk_vals, chunk_fv = chunk.run(len(history), n)
        for j, lv in enumerate(chunk_vals):
            epoch_idx = len(history)
            history.append(lv)
            if epoch_idx % log_every == 0:
                logger.log("ppi_epoch", epoch=epoch_idx,
                           loss_train=chunk_tr[j], f1_train=chunk_ftr[j],
                           loss_val=lv, f1_val=chunk_fv[j],
                           time=time.time() - t0)
                t0 = time.time()
            # reference patience policy over the full history
            if epoch_idx - int(np.argmin(history)) >= patience:
                stopped = True
                break
        if checkpoint_dir:
            # chunk-boundary checkpoint with full resume bookkeeping
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
    # moments), as the JAX package's does
    with torch.no_grad():
        for p, best in zip(parameters(state.params),
                           parameters(chunk.best_params)):
            p.copy_(best)
    best_epoch = int(chunk.best_epoch)

    losses_t, _, tp, fp, fn = banked_eval(cfg, bank_te, batch_size, mesh)(
        state.params)
    test_loss = float(losses_t.mean())
    tp, fp, fn = float(tp), float(fp), float(fn)
    test_f1 = 2 * tp / max(2 * tp + fp + fn, 1.0)
    logger.log("test", loss=test_loss, accuracy=test_f1)
    return FitResult(
        best_epoch=best_epoch,
        best_val_loss=float(chunk.best_val),
        test_loss=test_loss,
        test_acc=test_f1,
        epochs_run=len(history),
        state=state,
        history=history,
    )


# ---------------------------------------------------------------------------
# The stacked loop: each epoch's batches of one static shape, stacked on the
# host and copied to the device at once, its steps run back to back, and
# one host read of the epoch's metrics.
# ---------------------------------------------------------------------------


class StackedWalks(NamedTuple):
    """One stream side's walks of ``B`` stacked batches: ``row_ptr`` and
    ``tile_ptr`` stacked (their shapes follow the batch's padded shape),
    ``split_at`` flat with host offsets (a walk's pieces vary in number),
    and each walk's ``max_run`` on the host."""

    row_ptr: torch.Tensor  # [B, n_tiles * (TILE + 1) + 1] int32
    tile_ptr: torch.Tensor  # [B, n_tiles + 1] int32
    split_at: torch.Tensor  # flat int32, batch i at split_off[i]:split_off[i+1]
    split_off: np.ndarray  # [B + 1] int64
    max_run: np.ndarray  # [B] int64

    @classmethod
    def stack(cls, walks) -> "StackedWalks":
        off = np.cumsum([0] + [w.split_at.numel() for w in walks])
        return cls(torch.stack([w.row_ptr for w in walks]),
                   torch.stack([w.tile_ptr for w in walks]),
                   torch.cat([w.split_at for w in walks]), off,
                   np.asarray([w.max_run for w in walks], np.int64))

    def to(self, device) -> "StackedWalks":
        return self._replace(row_ptr=self.row_ptr.to(device),
                             tile_ptr=self.tile_ptr.to(device),
                             split_at=self.split_at.to(device))

    def walk(self, i: int):
        from pygat_tpu_torch.ops.stream import StreamWalk

        lo, hi = self.split_off[i], self.split_off[i + 1]
        return StreamWalk(self.row_ptr[i], self.tile_ptr[i],
                          self.split_at[lo:hi], int(self.max_run[i]))


class StackedBatches(NamedTuple):
    """``B`` padded batches of one shape with every leaf stacked on a new
    first axis (the JAX package's ``stack_batches`` pytree: features,
    the Graph's fields, labels), and the batches' walks of both stream
    sides beside them (None where the batches have none)."""

    features: torch.Tensor  # [B, N_pad, F_pad]
    graph: Any  # Graph with [B, ...] leaves
    labels: torch.Tensor  # [B, N_pad, C]
    walks: tuple[StackedWalks, StackedWalks] | None

    @property
    def n_batches(self) -> int:
        return self.features.shape[0]

    def to(self, device) -> "StackedBatches":
        """Every leaf on ``device``: the epoch's one copy."""
        return StackedBatches(
            self.features.to(device),
            type(self.graph)(*(None if t is None else t.to(device)
                               for t in self.graph)),
            self.labels.to(device),
            None if self.walks is None
            else tuple(w.to(device) for w in self.walks))

    def batch(self, i: int):
        """(x, graph, y) of batch ``i``: views of the stacked leaves, the
        graph's walks attached as :func:`~pygat_tpu_torch.graph.
        build_graph` attaches them."""
        from pygat_tpu_torch.graph import _remember_walk

        g = type(self.graph)(*(None if t is None else t[i]
                               for t in self.graph))
        if self.walks is not None:
            _remember_walk(g.r_local, self.walks[0].walk(i))
            _remember_walk(g.c_local, self.walks[1].walk(i))
        return self.features[i], g, self.labels[i]


def stack_batches(batches) -> StackedBatches:
    """Stack a list of :class:`~pygat_tpu_torch.data.ppi.PaddedBatch` of
    one padded shape (port of ``pygat_tpu/train/loop.py::stack_batches``),
    on the batches' device."""
    graphs = [pb.batch.graph for pb in batches]
    stacked = type(graphs[0])(*(
        None if leaves[0] is None else torch.stack(leaves)
        for leaves in zip(*graphs)))
    walks = None
    if all(g.stream_walk is not None and g.sender_walk is not None
           for g in graphs):
        walks = (StackedWalks.stack([g.stream_walk for g in graphs]),
                 StackedWalks.stack([g.sender_walk for g in graphs]))
    return StackedBatches(torch.stack([pb.features for pb in batches]),
                          stacked, torch.stack([pb.labels for pb in batches]),
                          walks)


def _stacked_train_epoch(state: TrainState, stacked: StackedBatches, loss_fn,
                         mesh: Mesh | None):
    """One epoch over ``stacked``: a step a batch, or under a mesh a
    super-step of ``D`` consecutive batches (:func:`superstep_slots`),
    rank ``r`` taking slot ``r`` and descending the weighted mean of the
    slots' losses, the gradients all-reduced. Returns the device tensor
    [2, steps] of each step's (weighted-mean) loss and micro-F1 times its
    weight, and the steps' weights (host)."""
    stats, weights = [], []
    n_data = 1 if mesh is None else mesh.n_data
    for ids, weight in superstep_slots(stacked.n_batches, n_data):
        j = 0 if mesh is None else mesh.data_index
        wsum = max(float(weight.sum()), 1.0)
        x, g, y = stacked.batch(int(ids[j]))
        state.optimizer.zero_grad(set_to_none=True)
        loss, f1, _ = loss_fn(state.params, x, g, y, state.generator, True)
        (loss * (float(weight[j]) / wsum)).backward()
        step = torch.stack([loss.detach(), f1]) * float(weight[j])
        if mesh is not None:
            all_reduce_grads(state.params, mesh.data_group)
            step = all_reduce_sum(step, mesh.data_group)
        state.optimizer.step()
        state.step += 1
        stats.append(step)
        weights.append(float(weight.sum()))
    return torch.stack(stats, 1), np.asarray(weights)


@torch.no_grad()
def _stacked_eval(params, stacked: StackedBatches, loss_fn) -> torch.Tensor:
    """[5, B] device tensor of each batch's (loss, micro-F1, tp, fp, fn),
    without dropout or autograd."""
    rows = []
    for i in range(stacked.n_batches):
        x, g, y = stacked.batch(i)
        loss, f1, out = loss_fn(params, x, g, y, None, False)
        rows.append(torch.stack([loss, f1, *f1_counts(out, y,
                                                      mask=g.node_mask)]))
    return torch.stack(rows, 1)


def fit_inductive_fast(
    cfg: GATConfig,
    data,  # pygat_tpu_torch.data.ppi.PPIData
    *,
    batch_size: int,
    lr: float,
    weight_decay: float,
    epochs: int,
    patience: int,
    seed: int = 72,
    checkpoint_dir: str | None = None,
    dataset_tag: str = "ppi",
    logger: TrainLogger | None = None,
    init_params: Any = None,
    device: torch.device | str | None = None,
    mesh: Mesh | None = None,
) -> FitResult:
    """:func:`fit_inductive` with one host read an epoch (port of the JAX
    ``fit_inductive_fast``, loop.py:582-733, whose one dispatch an epoch is
    a scan over stacked batches): the batches of the three splits are
    padded to one shape (``batch_bounds`` over train, valid and test); each
    epoch's shuffled train batches (``seed + epoch``, as
    :func:`fit_inductive`) are built on the host, stacked
    (:func:`stack_batches`) and copied to the device at once; the steps run
    back to back, then the validation batches (stacked once); the next
    epoch's batches are built while the device runs them; and the host
    reads the epoch's losses and F1s once and logs one ``ppi_epoch`` record
    of their means (its ``time`` covers the epoch's steps and the next
    epoch's batches). The same early stop, checkpoint rotation (the best and
    the final epoch kept) and best-model restore as :func:`fit_inductive`;
    the test loss is the mean of the test batches' losses and the micro-F1
    comes from their summed counts. Capturing the epoch in a CUDA graph is
    later work.

    ``mesh`` (every rank of the group calls this; ``device`` defaults to
    the mesh's) trains data-parallel as the JAX package's
    ``make_sharded_inductive_epochs``: ``D`` consecutive batches make one
    optimizer step (:func:`superstep_slots`; the last one's pad slots weigh
    0), rank ``r`` computing slot ``r``'s loss, the weighted-mean loss's
    gradients all-reduced, rank 0's parameters broadcast first, each rank's
    dropout from its own generator, and rank 0 alone writing checkpoints.
    The logged train metrics are the weighted means over the slots; every
    rank evaluates every validation and test batch. With a model axis the
    data index deals the batches and the model index names the heads, as
    in :func:`fit_inductive_banked`."""
    from pygat_tpu_torch.data.ppi import batch_bounds, make_batches
    from pygat_tpu_torch.parallel.collectives import barrier

    device = resolve_device(device if device is not None or mesh is None
                            else mesh.device)
    logger = logger or TrainLogger()
    state = _init(cfg, seed, lr, weight_decay, init_params, device)
    if mesh is not None:
        state.generator = _dropout_generator(device, seed, mesh)
        state = shard_state(state, mesh, logger)
    writes = mesh is None or mesh.is_main
    loss_fn = _make_loss(cfg, mesh)

    bounds = [batch_bounds(g, batch_size)
              for g in (data.train, data.valid, data.test)]
    n_pad = max(b[0] for b in bounds)
    e_pad = max(b[1] for b in bounds)

    def stacked(graphs, **kw):
        return stack_batches(list(make_batches(
            graphs, batch_size, n_pad=n_pad, e_pad=e_pad, device="cpu",
            **kw))).to(device)

    val_stacked = stacked(data.valid)
    best = float("inf")
    best_epoch = 0
    bad_counter = 0
    history: list[float] = []
    epoch = -1

    t0 = time.time()
    train = stacked(data.train, shuffle=True, seed=seed)
    for epoch in range(epochs):
        tr, w_tr = _stacked_train_epoch(state, train, loss_fn, mesh)
        ev = _stacked_eval(state.params, val_stacked, loss_fn)
        # the next epoch's batches are built on the host while the device
        # runs this epoch's steps, before the epoch's one host read
        train = (stacked(data.train, shuffle=True, seed=seed + epoch + 1)
                 if epoch + 1 < epochs else None)
        tr, ev = (np.asarray(v, np.float64) for v in
                  torch.cat([tr, ev[:2]], 1).cpu().split(
                      [tr.shape[1], ev.shape[1]], 1))
        loss_val = float(ev[0].mean())
        logger.log("ppi_epoch", epoch=epoch,
                   loss_train=float(tr[0].sum() / w_tr.sum()),
                   f1_train=float(tr[1].sum() / w_tr.sum()),
                   loss_val=loss_val, f1_val=float(ev[1].mean()),
                   time=time.time() - t0)
        t0 = time.time()
        history.append(loss_val)

        if checkpoint_dir:
            save_state(mesh, checkpoint_dir, epoch, dataset_tag, state)
        if loss_val < best:
            best = loss_val
            best_epoch = epoch
            bad_counter = 0
        else:
            bad_counter += 1
        if bad_counter >= patience:
            break
        if checkpoint_dir and writes:
            ckpt.rotate_below_best(checkpoint_dir, dataset_tag, best_epoch)
    del train

    if checkpoint_dir:
        # keep the final-epoch checkpoint too: a resume then continues from
        # where the run stopped instead of replaying post-best epochs
        if writes:
            ckpt.rotate_above_best(checkpoint_dir, dataset_tag, best_epoch,
                                   keep_epoch=epoch)
        if mesh is not None:
            barrier()  # every rank reads the best checkpoint rank 0 wrote
        state, _ = restore_state(
            ckpt.best_path(checkpoint_dir, dataset_tag, best_epoch), state)

    te = _stacked_eval(state.params, stacked(data.test), loss_fn)
    te = np.asarray(te.cpu(), np.float64)
    test_loss = float(te[0].mean())
    tp, fp, fn = (float(v) for v in te[2:].sum(1))
    test_f1 = 2 * tp / max(2 * tp + fp + fn, 1.0)
    logger.log("test", loss=test_loss, accuracy=test_f1)
    return FitResult(
        best_epoch=best_epoch,
        best_val_loss=best,
        test_loss=test_loss,
        test_acc=test_f1,
        epochs_run=epoch + 1,
        state=state,
        history=history,
    )
