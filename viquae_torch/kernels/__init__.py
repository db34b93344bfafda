"""nvcc build and ctypes loading of the CUDA kernels in csrc/."""
