"""polar_codes_torch — the PyTorch and CUDA port of polar_codes_tpu.

The port mirrors the JAX package's layout (construction/, models/, ops/,
dsp/, utils/) and runs its main path — (N, K) CA-SCL with a CRC, BPSK over
AWGN — on an NVIDIA Hopper card through two hand-written CUDA kernels under
csrc/: the butterfly encoder (ops/butterfly_kernel.py) and the SCL subtree
decoder (ops/scl_kernel_bl.py). Each kernel's wrapper runs a plain PyTorch
version for tensors on the CPU and the kernel for tensors on the card.

Importing the package builds nothing and imports neither JAX nor the JAX
package; the kernels are compiled by ops/_build.py at their first launch.
"""

__version__ = "0.1.0"
