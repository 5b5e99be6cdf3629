"""Plain PyTorch version of the box lower bound.

``box_lb`` is the function the CUDA kernel computes; the wrapper in
``ops.py`` runs it for CPU tensors and ``chip_smoke.py`` holds the kernel
against it on the card.
"""
from __future__ import annotations

import torch


def box_lb(q: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
           ) -> torch.Tensor:
    """q (Q, d) against boxes lo/hi (L, d) → (Q, L): the square root of the
    summed squared distances from each point to each box, per dimension
    max(lo − q, q − hi, 0); a non-finite term (an open side at ±inf)
    counts 0."""
    d = torch.clamp_min(torch.maximum(lo[None] - q[:, None],
                                      q[:, None] - hi[None]), 0.0)
    d = torch.where(torch.isfinite(d), d, 0.0)
    return torch.sqrt((d * d).sum(dim=-1))
