"""polar_codes_torch — the PyTorch and CUDA port of polar_codes_tpu.

The port mirrors the JAX package's layout (construction/, models/, ops/,
dsp/, utils/, sim/, parallel/, tools/) and runs its paths — (N, K) CA-SCL
with a CRC or CMAC, the simulator's adaptive decoder, Fast-SSC, SCAN,
SC-Flip, the genie error locator, the puncturer and the large-N SC and
SCL decoders (both schedules), BPSK or ASK over AWGN or Rayleigh, and the
Monte-Carlo simulator with its pcsim CLI (python -m
polar_codes_torch.sim.cli) — on an NVIDIA Hopper card through hand-written
CUDA kernels under csrc/: the butterfly encoder (ops/butterfly_kernel.py),
the SCL and Fast-SSC subtree decoders (ops/scl_kernel_bl.py,
ops/fastssc_kernel.py), the SCAN sweeps (ops/scan_kernel.py) and the
masked chunk decoders (ops/large_kernel.py). Each kernel's wrapper runs a
plain PyTorch version for tensors on the CPU and the kernel for tensors on
the card.

Importing the package builds nothing and imports neither JAX nor the JAX
package; the kernels are compiled by ops/_build.py at their first launch.
"""

__version__ = "0.1.0"
