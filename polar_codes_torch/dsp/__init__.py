from .modem import Bpsk, bpsk_modulate, bpsk_demodulate
from .channel import Awgn, awgn_sigma, add_awgn

__all__ = [
    "Bpsk", "bpsk_modulate", "bpsk_demodulate",
    "Awgn", "awgn_sigma", "add_awgn",
]
