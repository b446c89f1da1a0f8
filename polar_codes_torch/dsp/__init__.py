from .modem import (
    Modem,
    Bpsk,
    Ask,
    bpsk_modulate,
    bpsk_demodulate,
    ask_modulate,
    ask_demodulate,
)
from .channel import (
    Transmitter,
    Awgn,
    Rayleigh,
    Scale,
    awgn_sigma,
    add_awgn,
    apply_rayleigh,
    awgn_from,
    rayleigh_from,
)

__all__ = [
    "Modem",
    "Bpsk",
    "Ask",
    "bpsk_modulate",
    "bpsk_demodulate",
    "ask_modulate",
    "ask_demodulate",
    "Transmitter",
    "Awgn",
    "Rayleigh",
    "Scale",
    "awgn_sigma",
    "add_awgn",
    "apply_rayleigh",
    "awgn_from",
    "rayleigh_from",
]
