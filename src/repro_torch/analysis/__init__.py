"""Analytic cost models (port of part of ``repro.analysis``)."""
