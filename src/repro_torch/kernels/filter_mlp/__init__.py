"""Fused per-leaf filter-MLP inference kernel."""
