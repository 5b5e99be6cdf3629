"""Sakoe–Chiba-banded dynamic time warping (the paper's §3 DTW claim)."""
