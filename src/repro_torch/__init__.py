"""PyTorch port of ``repro`` for an NVIDIA H100: same module layout, hand-written
CUDA kernels in place of the Pallas TPU kernels.  Imports neither JAX nor
anything of ``repro``."""
