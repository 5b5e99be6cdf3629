"""LeaFi on PyTorch and CUDA: the port of the ``repro`` JAX package.

The JAX package stays the reference; this package imports ``torch`` and
numpy and nothing of it.  Entry points run on the card unless the caller
passes ``device="cpu"``.
"""
