"""Codes, detectors, encoder and the SCL decoder."""
