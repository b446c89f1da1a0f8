"""Bit conventions, CUDA-event timing, and the carry of the JAX package's
code state into the port."""
