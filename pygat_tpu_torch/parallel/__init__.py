"""Multi-GPU training on ``torch.distributed`` (port of
``pygat_tpu/parallel``): the process mesh and its data and model groups,
the collectives (the model axis's combines among them), the ring
partition and ring attention, the ring model and the dense model by
receiver rows, and the replicated or head-split state."""

from pygat_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    initialize_distributed,
    make_mesh,
)
