"""Plain torch ops on the (H, W*C) rows layout, and the CUDA kernels."""
