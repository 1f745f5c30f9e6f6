"""Per-dataset model/training presets (port of
``pygat_tpu/models/presets.py``; values from the reference CLIs,
train.py:47-87, train_ppi.py:43-55)."""

from __future__ import annotations

from pygat_tpu_torch.models.gat import GATConfig

# Dataset constants (reference train.py:20-28, train_ppi.py:22-23).
CORA_NUM_INPUT_FEATURES = 1433
CORA_NUM_CLASSES = 7
CITESEER_NUM_INPUT_FEATURES = 3703
CITESEER_NUM_CLASSES = 6
PUBMED_NUM_INPUT_FEATURES = 500
PUBMED_NUM_CLASSES = 3
PPI_NUM_INPUT_FEATURES = 50
PPI_NUM_CLASSES = 121


def gat_config(dataset: str, layer_type: str = "GAT_sparse") -> GATConfig:
    base = PRESETS[dataset]
    return GATConfig(layer_type=layer_type, **base)


PRESETS = {
    "cora": dict(
        nlayers=2,
        nheads=(8, 1),
        nfeats=(CORA_NUM_INPUT_FEATURES, 8, CORA_NUM_CLASSES),
        skip_connection=False,
        alpha=0.2,
        dropout=0.6,
    ),
    "citeseer": dict(
        nlayers=2,
        nheads=(8, 1),
        nfeats=(CITESEER_NUM_INPUT_FEATURES, 8, CITESEER_NUM_CLASSES),
        skip_connection=False,
        alpha=0.2,
        dropout=0.6,
    ),
    "pubmed": dict(
        nlayers=2,
        nheads=(8, 8),
        nfeats=(PUBMED_NUM_INPUT_FEATURES, 8, PUBMED_NUM_CLASSES),
        skip_connection=False,
        alpha=0.2,
        dropout=0.6,
    ),
    "ppi": dict(
        nlayers=3,
        nheads=(4, 4, 6),
        nfeats=(PPI_NUM_INPUT_FEATURES, 256, 256, PPI_NUM_CLASSES),
        skip_connection=True,
        alpha=0.2,
        dropout=0.0,
    ),
}

TRAIN_PRESETS = {
    "cora": dict(lr=0.005, weight_decay=5e-4),
    "citeseer": dict(lr=0.005, weight_decay=5e-4),
    "pubmed": dict(lr=0.01, weight_decay=1e-3),
    "ppi": dict(lr=0.005, weight_decay=0.0),
}
