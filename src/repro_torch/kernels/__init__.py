"""Hand-written CUDA kernels of the port (``csrc/``), their wrappers
(``ops``), plain PyTorch versions (``ref``) and the nvcc build (``build``).
Nothing is compiled at import: a kernel builds at its first launch."""
