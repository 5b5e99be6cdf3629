"""Wrappers for the box lower bound (port of ``repro.kernels.box_lb.ops``).

* ``sax_lb``:   MINDIST(q, word)² = (m/l)·Σ_d boxdist(paa_d, [lo_d, hi_d])²
                → pre-scale the PAA coordinates and edges by sqrt(m/l).
* ``eapca_lb``: Σ_s w_s·(boxdist(μ)² + boxdist(σ)²)
                → concatenate the μ and σ blocks, pre-scaled by √w_s.

After pre-scaling both are the plain box bound.  For CPU tensors the plain
version in ``ref.py`` runs; for CUDA tensors the hand-written kernel
launches or the call raises.
"""
from __future__ import annotations

import torch

from . import kernel, ref
from ..common import on_cpu as _on_cpu


def box_lb(q: torch.Tensor, lo: torch.Tensor,
           hi: torch.Tensor) -> torch.Tensor:
    """q (Q, d) against boxes lo/hi (L, d) → (Q, L)."""
    if _on_cpu(q, lo, hi):
        return ref.box_lb(q, lo, hi)
    return kernel.box_lb_cuda(q.float().contiguous(), lo.float().contiguous(),
                              hi.float().contiguous())


def sax_lb(query_paa: torch.Tensor, edges: torch.Tensor, *,
           length: int) -> torch.Tensor:
    """query_paa (Q, l), edges (L, l, 2) → (Q, L) iSAX MINDIST."""
    wl = edges.shape[1]
    scale = torch.sqrt(torch.tensor(float(length), dtype=torch.float32,
                                    device=edges.device) / wl)
    return box_lb(query_paa * scale, edges[..., 0] * scale,
                  edges[..., 1] * scale)


def eapca_lb(query_stats: torch.Tensor, boxes: torch.Tensor,
             seg_len: torch.Tensor) -> torch.Tensor:
    """query_stats (Q, s, 2), boxes (L, s, 4), seg_len (s,) → (Q, L)."""
    w = torch.sqrt(seg_len.float())
    q = torch.cat([query_stats[..., 0] * w, query_stats[..., 1] * w], -1)
    lo = torch.cat([boxes[..., 0] * w, boxes[..., 2] * w], -1)
    hi = torch.cat([boxes[..., 1] * w, boxes[..., 3] * w], -1)
    return box_lb(q, lo, hi)


reference = ref.box_lb
