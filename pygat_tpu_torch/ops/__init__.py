"""Sparse attention ops: segment sums, row gathers, corner-turn passes and
the fused attention forwards, each a hand-written CUDA kernel beside its
plain PyTorch version."""
