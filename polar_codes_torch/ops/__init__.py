"""f/g, the butterfly transform, and the kernels K1 and K2 with their
plain versions. The CUDA sources are built at first launch (_build.py)."""
