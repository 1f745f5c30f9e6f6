"""The round-1 BCSR fused attention, ported (counterpart of the JAX
package's ``tests/legacy_bcsr/``).

No model reaches it: the JAX package retired it from its layers, and its
tests still use it as an oracle and a comparison. The modules keep the
reference's names:

* :mod:`.tiles`: the host BCSR tiling (``TiledGraph``, ``tile_graph``,
  ``tile_stats``), in numpy;
* :mod:`.fused_attention`: the fused attention forward, whose kernel is
  the hand-written ``csrc/bcsr_attention.cu`` (wrapper ``bcsr_attention``),
  beside its plain PyTorch version;
* :mod:`.sparse_attention`: ``gat_attention_v1`` with its two routes, the
  segment-op forward and the fused kernel with its analytic backward.
"""
