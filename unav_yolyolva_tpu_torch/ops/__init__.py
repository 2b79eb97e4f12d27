"""Tensor functions of the port. The three kernel modules (fused_mhca,
fused_csp, fused_nms) each hold hand-written CUDA kernel wrappers (forward,
and for MHCA and CSP the backward) and their plain PyTorch versions."""
