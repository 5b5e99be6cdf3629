"""Synthetic data series (port of ``repro.data``)."""
