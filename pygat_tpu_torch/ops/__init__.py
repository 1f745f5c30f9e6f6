"""Sparse attention ops: segment sums, row gathers, corner-turn passes, the
fused attention forwards and the SpMM family, each kernel a hand-written
CUDA kernel beside its plain PyTorch version.

Exported as the JAX package's ``pygat_tpu.ops`` exports them, where ported:
the SpMM ops (the counterparts of the reference's ``SpecialSpmm``,
``layers.py:70-95``) over the receiver stream (:func:`spmm_graph`), the
panel layout (:func:`panel_spmm_graph`), a band plan (:func:`spmm_banded`)
and the corner plans (:func:`spmm_corner_graph`), the SDDMM, the
segment reductions, gathers, segment softmax and impl switch
(:func:`set_segment_impl`) of :mod:`.segment`, the fused-attention switch
:func:`set_fused_attention` and the differentiable :func:`stream_expand`.

Importing the package also imports
:mod:`pygat_tpu_torch.legacy_bcsr.fused_attention`, which registers the
``bcsr_attention`` kernel's wrapper, so that :func:`build.launch_counts`
covers every kernel of ``build.ENTRY_POINTS``."""

from pygat_tpu_torch.ops.segment import (  # noqa: F401
    gather_receivers,
    gather_receivers_hn,
    gather_senders,
    segment_max,
    segment_softmax_stable,
    segment_sum,
    segment_sum_receivers,
    segment_sum_senders,
    sender_segment_sum,
    set_segment_impl,
    sorted_segment_max,
    sorted_segment_sum,
    take_receivers,
    take_senders,
    use_impl,
)
from pygat_tpu_torch.ops.spmm import spmm, spmm_graph  # noqa: F401
from pygat_tpu_torch.ops.sddmm import sddmm, sddmm_graph  # noqa: F401
from pygat_tpu_torch.ops.stream import (  # noqa: F401
    build_stream_layout,
    stream_scatter,
    stream_segment_sum,
)
from pygat_tpu_torch.ops.fused_stream import (  # noqa: F401
    fused_enabled,
    fused_v1_attention,
    fused_v2_attention,
    set_fused_attention,
)
from pygat_tpu_torch.ops.panel import (  # noqa: F401
    build_panel_layout,
    panel_spmm,
    panel_spmm_graph,
)
from pygat_tpu_torch.ops.banded import spmm_banded  # noqa: F401
from pygat_tpu_torch.ops.corner import (  # noqa: F401
    corner_permute,
    permute_rows,
    plan_corner_turn,
    plan_pair,
)
from pygat_tpu_torch.ops.large import (  # noqa: F401
    maybe_plan_corner,
    plan_csc_to_csr,
    set_corner,
    spmm_corner_graph,
    stream_expand,
)
from pygat_tpu_torch.ops.fused_corner import (  # noqa: F401
    fused_v1_attention_corner,
    fused_v2_attention_corner,
)

# registers the bcsr_attention wrapper (a plain import: the module imports
# this package's build first, so it may be mid-import here)
import pygat_tpu_torch.legacy_bcsr.fused_attention  # noqa: E402, F401
