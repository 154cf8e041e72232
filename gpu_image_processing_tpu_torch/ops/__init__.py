"""Plain torch ops (level 1 on (H, W*C) rows and on (H, W, C) images), the
planar registry, and the CUDA kernels."""
