"""Hand-written Hopper kernels and their wrappers (see ``common.py``)."""
