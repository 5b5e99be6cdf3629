"""Plain PyTorch versions of the l2_scan kernels.

``pairwise_l2_matmul`` and ``slab_l2_matmul`` compute what the CUDA kernels
compute (‖q‖² + ‖s‖² − 2·q·sᵀ, then sqrt(max(·, 0))); the wrappers in
``ops.py`` run them for CPU tensors, and ``chip_smoke.py`` holds the kernels
against them on the card.  ``pairwise_l2`` is the direct (diff-square) form.
"""
from __future__ import annotations

import torch


def pairwise_l2(queries: torch.Tensor, series: torch.Tensor) -> torch.Tensor:
    """Exact pairwise euclidean distances, direct form.  (Q, m) × (B, m) → (Q, B)."""
    diff = queries[:, None, :].float() - series[None, :, :].float()
    return torch.sqrt((diff * diff).sum(-1))


def pairwise_l2_matmul(queries: torch.Tensor,
                       series: torch.Tensor) -> torch.Tensor:
    """Matmul-decomposed form (what the pairwise kernel computes)."""
    q = queries.float()
    s = series.float()
    qn = (q * q).sum(-1)
    sn = (s * s).sum(-1)
    d2 = qn[:, None] + sn[None, :] - 2.0 * (q @ s.T)
    return torch.sqrt(torch.clamp_min(d2, 0.0))


def slab_l2_matmul(queries: torch.Tensor, slabs: torch.Tensor) -> torch.Tensor:
    """(F, Nq, m) × (F, R, m) → (F, Nq, R), what the slab kernel computes."""
    q = queries.float()
    s = slabs.float()
    qn = (q * q).sum(-1)                                 # (F, Nq)
    sn = (s * s).sum(-1)                                 # (F, R)
    dot = torch.bmm(q, s.transpose(1, 2))
    return torch.sqrt(torch.clamp_min(
        qn[:, :, None] + sn[:, None, :] - 2.0 * dot, 0.0))
