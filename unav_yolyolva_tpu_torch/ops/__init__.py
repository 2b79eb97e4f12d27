"""Tensor functions of the port. The kernel modules (fused_mhca, fused_csp,
fused_tblock, fused_nms) each hold hand-written CUDA kernel wrappers
(forward, and for MHCA, CSP and TBlock the backward) and their plain
PyTorch versions; gemm_tc exposes the tensor-core product they share."""
