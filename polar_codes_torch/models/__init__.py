"""Codes, detectors, the encoder, the puncturer, and the SC, SCL,
Fast-SSC, adaptive, SCAN, SC-Flip (depth-first) and large-N decoders and
the genie error locator."""
