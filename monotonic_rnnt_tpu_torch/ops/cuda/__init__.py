"""Hand-written CUDA kernels (csrc/) and the DP-fused pipeline built on them."""
