"""Monte-Carlo BER/BLER simulation (the pcsim equivalent): job
configuration, the construct -> encode -> modulate -> channel ->
demodulate -> decode -> count chain, per-job timing statistics, and CSV
results in pcsim's 23-column schema. The port of polar_codes_tpu/sim/."""

from .montecarlo import MonteCarlo, JobResult, Statistics, write_csv

__all__ = ["MonteCarlo", "JobResult", "Statistics", "write_csv"]
