"""Pairwise and slab Euclidean-distance kernels."""
