"""f/g, the butterfly transform, and the kernels K1-K7 with their plain
versions. The CUDA sources are built at first launch (_build.py)."""
