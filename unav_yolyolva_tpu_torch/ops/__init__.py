"""Tensor functions of the port. The three kernel modules (fused_mhca,
fused_csp, fused_nms) each hold a hand-written CUDA kernel wrapper and its
plain PyTorch version."""
