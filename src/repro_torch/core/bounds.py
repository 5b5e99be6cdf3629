"""Summarization lower bounds (port of ``repro.core.bounds``).

``eapca_lower_bound`` and ``sax_lower_bound`` are plain torch in the
reference's op order, and ``lower_bounds`` uses them on the CPU.  On the
card it goes through the box lower-bound kernel (``kernels/box_lb``),
which computes the same bounds after pre-scaling: the scaled differences
round differently where a query lies close to a box edge (up to 2.2e-5
relative on the CPU at test size), so the CPU keeps the reference's order
and its values agree with the reference's to 1e-6.
Both bounds satisfy lb(q, leaf) ≤ min_{s ∈ leaf} d(q, s).
"""
from __future__ import annotations

import torch

from . import summaries
from .flat_index import FlatIndex
from ..kernels.box_lb import ops as box_lb_ops
from ..kernels.common import on_cpu


def eapca_lower_bound(query_stats: torch.Tensor, boxes: torch.Tensor,
                      seg_len: torch.Tensor) -> torch.Tensor:
    """DSTree EAPCA box bound: query_stats (..., s, 2), boxes (L, s, 4),
    seg_len (s,) → (..., L) euclidean lower bounds (see the reference's
    docstring for the derivation)."""
    mu_q = query_stats[..., None, :, 0]          # (..., 1, s)
    sd_q = query_stats[..., None, :, 1]
    mu_lo, mu_hi = boxes[..., 0], boxes[..., 1]  # (L, s)
    sd_lo, sd_hi = boxes[..., 2], boxes[..., 3]
    d_mu = torch.clamp_min(torch.maximum(mu_lo - mu_q, mu_q - mu_hi), 0.0)
    d_sd = torch.clamp_min(torch.maximum(sd_lo - sd_q, sd_q - sd_hi), 0.0)
    lb2 = (seg_len * (d_mu * d_mu + d_sd * d_sd)).sum(dim=-1)
    return torch.sqrt(lb2)


def sax_lower_bound(query_paa: torch.Tensor, edges: torch.Tensor,
                    length: int) -> torch.Tensor:
    """iSAX MINDIST from precomputed symbol boxes: query_paa (..., l),
    edges (L, l, 2) → (..., L)."""
    q = query_paa[..., None, :]                  # (..., 1, l)
    lo, hi = edges[..., 0], edges[..., 1]        # (L, l)
    d = torch.clamp_min(torch.maximum(lo - q, q - hi), 0.0)
    d = torch.where(torch.isfinite(d), d, 0.0)   # ±inf edges at the extremes
    wl = edges.shape[-2]
    return torch.sqrt((length / wl) * (d * d).sum(dim=-1))


def lower_bounds(index: FlatIndex, queries: torch.Tensor) -> torch.Tensor:
    """All-leaves lower bounds for a batch of queries → (Q, L)."""
    queries = torch.atleast_2d(queries)
    cpu = on_cpu(queries)
    if index.kind == "dstree":
        boxes = index.payload["eapca_box"]
        seg_len = index.payload["seg_len"]
        qstats = summaries.segment_stats(queries, boxes.shape[1])
        if cpu:
            return eapca_lower_bound(qstats, boxes, seg_len.float())
        return box_lb_ops.eapca_lb(qstats, boxes, seg_len)
    if index.kind == "isax":
        edges = index.payload["sax_edges"]
        qpaa = summaries.paa(queries, edges.shape[1])
        if cpu:
            return sax_lower_bound(qpaa, edges, index.length)
        return box_lb_ops.sax_lb(qpaa, edges, length=index.length)
    raise ValueError(index.kind)
