"""Multi-GPU training on ``torch.distributed`` (port of
``pygat_tpu/parallel``): the process mesh, the collectives, the ring
partition and ring attention, the ring model, and the replicated state."""

from pygat_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    initialize_distributed,
    make_mesh,
)
