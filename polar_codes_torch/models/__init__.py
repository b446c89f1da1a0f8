"""Codes, detectors, the encoder, and the SC, SCL, Fast-SSC, adaptive,
SCAN and large-N decoders."""
