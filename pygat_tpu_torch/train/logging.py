"""Structured training logger: reference-style stdout lines + optional JSONL.

The reference's observability is bare prints (train.py:172-177,
train_ppi.py:126-146); this keeps those exact fields human-readable on
stdout and adds a machine-readable .jsonl stream (SURVEY §5 'metrics').
"""

from __future__ import annotations

import json
import sys
import time


class TrainLogger:
    def __init__(self, jsonl_path: str | None = None, stream=None):
        self.jsonl_path = jsonl_path
        self.stream = stream or sys.stdout
        self._fh = open(jsonl_path, "a") if jsonl_path else None

    def log(self, kind: str, **fields) -> None:
        if self._fh:
            rec = {"kind": kind, "ts": time.time(), **fields}
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        self.stream.write(self.format_line(kind, fields) + "\n")

    @staticmethod
    def format_line(kind: str, fields: dict) -> str:
        if kind == "epoch":
            # mirrors train.py:172-177
            return (
                "Epoch: {:04d} loss_train: {:.4f} acc_train: {:.4f} "
                "loss_val: {:.4f} acc_val: {:.4f} time: {:.4f}s".format(
                    fields["epoch"] + 1,
                    fields["loss_train"],
                    fields["acc_train"],
                    fields["loss_val"],
                    fields["acc_val"],
                    fields["time"],
                )
            )
        if kind == "test":
            # mirrors train.py:187-189
            return "Test set results: loss= {:.4f} accuracy= {:.4f}".format(
                fields["loss"], fields["accuracy"]
            )
        if kind == "ppi_epoch":
            return (
                "Epoch: {:04d} loss_train: {:.4f} f1_train: {:.4f} "
                "loss_val: {:.4f} f1_val: {:.4f} time: {:.4f}s".format(
                    fields["epoch"] + 1,
                    fields["loss_train"],
                    fields["f1_train"],
                    fields["loss_val"],
                    fields["f1_val"],
                    fields["time"],
                )
            )
        if kind == "ppi_batch":
            return (
                "[{split}] Epoch: {epoch:04d} Batch: {batch:04d} "
                "loss_{tag}: {loss:.4f} f1_{tag}: {f1:.4f} time: {time:.4f}s".format(
                    split=fields["split"].capitalize(),
                    epoch=fields["epoch"] + 1,
                    batch=fields["batch"] + 1,
                    tag=fields["split"] if fields["split"] != "valid" else "val",
                    loss=fields["loss"],
                    f1=fields["f1"],
                    time=fields["time"],
                )
            )
        return f"{kind}: " + " ".join(f"{k}={v}" for k, v in fields.items())

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
