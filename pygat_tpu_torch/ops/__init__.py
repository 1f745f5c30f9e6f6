"""Sparse attention ops: stream segment sums and the fused GATv1 forward,
each a hand-written CUDA kernel beside its plain PyTorch version."""
