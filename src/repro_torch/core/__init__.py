"""Index, search, build and calibration (port of ``repro.core``)."""
