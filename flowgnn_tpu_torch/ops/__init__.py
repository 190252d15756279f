"""Device ops: segment primitives and the hand-written CUDA kernels."""
