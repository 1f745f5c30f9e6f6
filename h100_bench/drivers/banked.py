"""The banked inductive loop: ``train.inductive.BankedEpochs``, the loop of
``fit_inductive_banked`` (``train_ppi --epoch-scan``).

Set-up builds what ``fit_inductive_banked`` builds for its epochs: one
per-graph bound over the three splits (``data.ppi.bank_bounds``), the
device-resident banks of the train and validation graphs
(``data.ppi.build_bank``), Adam, and one ``BankedEpochs`` of
``epoch_chunk`` epochs with no epoch budget and no patience. Its first
``n`` calls run one epoch each; the window then calls it with its whole
chunk. An epoch is the trainer's own: the train graphs in an order drawn
from the seed, one Adam step a batch, then the validation graphs' loss and
the best-model gate.

With the configuration's ``deployment.data_parallel`` D > 1 every rank of a process group of D
(``ranks.py``) builds the same session, as ``fit_inductive_banked(mesh=)``
does (``train_ppi --epoch-scan --mesh D,1``): a (D, 1) mesh, rank 0's state
replicated, and the loop's super-steps of D batches, one a rank, their
gradients all-reduced before each Adam step.
"""

from __future__ import annotations

import math

import torch

from h100_bench.seeds import derive
from h100_bench.weights import init_weights, layers

NO_BUDGET = 2 ** 62
CHUNK = 256  # slots per chunk of the receiver and sender streams


class Session:
    def __init__(self, cell, device, data):
        from pygat_tpu_torch.data.ppi import PPIGraph, bank_bounds, build_bank
        from pygat_tpu_torch.ops import build

        model, spans = cell.config["model"], cell.spans
        self.k = int(cell.settings["epoch_chunk"])
        self.b = int(model["batch_size"])
        device = torch.device(device)
        self.mesh = None
        dp = data_parallel(cell.config)
        if dp > 1:
            from pygat_tpu_torch.parallel.mesh import make_mesh

            self.mesh = make_mesh(dp, 1, device=device)
        with spans.span("setup.data_s"):
            splits = {name: [PPIGraph(g["features"], g["labels"],
                                      g["senders"], g["receivers"],
                                      g["weights"], g["num_nodes"])
                             for g in graphs]
                      for name, graphs in data.items()}
        with spans.span("setup.plan_s"):
            n_pg, e_pg = bank_bounds([splits["train"], splits["valid"],
                                      splits["test"]])
            bank_tr = build_bank(splits["train"], n_pg, e_pg, device)
            bank_va = build_bank(splits["valid"], n_pg, e_pg, device)
        in_width = bank_tr.features.shape[-1]
        if in_width != int(cell.settings["input_columns"]):
            raise RuntimeError(f"{cell.name}: the program feeds {in_width} "
                               "input columns, the cell "
                               f"{cell.settings['input_columns']}")
        self.model, self.data, self.seed = model, data, cell.seed
        self.banks, self.in_width, self.device = (bank_tr, bank_va), in_width, device
        self._counts = build.launch_counts
        self._per_epoch: dict = {}
        with spans.span("setup.warm_s"):
            self.reset()

    def reset(self) -> None:
        """A fresh model, optimiser and loop on the same banks."""
        from pygat_tpu_torch.models.gat import GATConfig
        from pygat_tpu_torch.models.layers import V1Params
        from pygat_tpu_torch.parallel.distributed import shard_train_state
        from pygat_tpu_torch.train.inductive import BankedEpochs
        from pygat_tpu_torch.train.state import init_state, make_optimizer
        from pygat_tpu_torch.utils.platform import make_generator

        model, device = self.model, self.device
        self.chunk = self.state = None
        cfg = GATConfig(nlayers=len(model["heads"]),
                        nheads=tuple(model["heads"]),
                        nfeats=(self.in_width,) + tuple(model["widths"][1:]),
                        dropout=float(model["dropout"]),
                        alpha=float(model["alpha"]),
                        layer_type=model["layer_type"],
                        skip_connection=bool(model.get("skip")))
        self.start = init_weights(model, self.seed, device, self.in_width)
        params = [V1Params(*(None if t is None else t.clone().requires_grad_()
                             for t in (p["W"], p["a"], p["skip"])))
                  for p in self.start]
        opt = make_optimizer(params, float(model["lr"]),
                             float(model["weight_decay"]))
        self.state = init_state(params, opt, make_generator(
            device, derive(self.seed, "dropout")))
        if self.mesh is not None:
            shard_train_state(self.state, self.mesh)
        self.chunk = BankedEpochs(
            cfg, self.state, *self.banks, self.b, n_epochs=self.k,
            seed=derive(self.seed, "order"), max_epochs=NO_BUDGET,
            patience=None, mesh=self.mesh)
        self.epoch = 0

    def first_steps(self, n: int) -> dict:
        """The chunk's first ``n`` calls, one epoch each: each epoch's mean
        train loss and validation loss, Adam's first moment after the first
        epoch, and each parameter's change after the last."""
        from pygat_tpu_torch.models.gat import parameters

        state = self.state
        out = {"train_loss": [], "val_loss": []}
        for k in range(n):
            rows = self.chunk.run(self.epoch, 1)
            self.epoch += 1
            out["train_loss"].append(rows[0][0])
            out["val_loss"].append(rows[2][0])
            if k == 0:
                out["moment"] = [
                    state.optimizer.state[p]["exp_avg"].detach().cpu().clone()
                    for p in parameters(state.params)]
        start = [t for p in self.start for t in (p["W"], p["a"], p["skip"])
                 if t is not None]
        out["change"] = [(p.detach() - s).cpu()
                         for p, s in zip(parameters(state.params), start)]
        return out

    def run_chunk(self) -> tuple[int, int]:
        """One call of the window: (epochs run, epochs whose train or
        validation loss was not finite). Keeps the wrapper calls of the
        chunk, per epoch (the port's launch counters)."""
        before = self._counts()
        rows = self.chunk.run(self.epoch, self.k)
        self.epoch += self.k
        after = self._counts()
        self._per_epoch = {name: (n - before.get(name, 0)) / self.k
                           for name, n in after.items()
                           if n != before.get(name, 0)}
        bad = sum(not (math.isfinite(t) and math.isfinite(v))
                  for t, v in zip(rows[0], rows[2]))
        return self.k, bad

    def launches_per_epoch(self) -> dict:
        return dict(self._per_epoch)

    def shapes(self) -> dict:
        """The model's layers and each forward pass an epoch needs: every
        train batch (with its backward) and every validation batch once,
        with the sizes of the batch's graph (members side by side at the
        bank's per-graph bound), over all ranks together."""
        bank_tr, _ = self.banks
        n_pg = bank_tr.nodes_per_graph
        e_s, e_s2 = bank_tr.senders.shape[1], bank_tr.c_local.shape[1]
        passes = []
        for split, train in (("train", True), ("valid", False)):
            graphs = self.data[split]
            for lo in range(0, len(graphs), self.b):
                members = graphs[lo:lo + self.b]
                nb = self.b
                passes.append(dict(
                    train=train, n_real=sum(g["num_nodes"] for g in members),
                    e_real=sum(len(g["senders"]) for g in members),
                    n_pad=nb * n_pg, e_s=nb * e_s, c=nb * e_s // CHUNK,
                    e_s2=nb * e_s2, c2=nb * e_s2 // CHUNK))
        return {"order": "stream", "layers": layers(self.model),
                "passes": passes}

    def close(self) -> None:
        self.chunk = self.state = self.banks = None


def data_parallel(config: dict) -> int:
    """The ranks the configuration's deployment trains over (1: one card)."""
    return int(config.get("deployment", {}).get("data_parallel", 1))


def setup(cell, device, data) -> Session:
    return Session(cell, device, data)
